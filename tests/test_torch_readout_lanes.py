"""The port's batched DES readout (the scenario, or lane, axis S) against
``jax.vmap`` of the JAX package's Pallas kernel over scenarios.

``ops.des_readout`` on ``u [S, T, H]`` with per-lane host rows ``[S, H]``,
per-lane caps ``[S, T]`` and per-lane scalars ``[S]`` (a per-lane scalar
of a row is ``[S, 1]``) computes what ``scenarios._scenario_lanes``
computes with ``jax.vmap`` of ``des_readout_pallas``: there the carbon,
ambient and price traces are closure constants shared by the lanes.  On
the CPU the port runs its plain version; the JAX side runs the Pallas
kernel in interpret mode, as its own tests do.  Inputs are made from a
seed with numpy and handed to both; the bars are those of
``tests/test_torch_kernels.py``.  ``chip_smoke.py`` holds the card
kernel against the plain version.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.des_readout import des_readout_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: one bf16 ulp, relative (8 significant bits)
BF16_ULP = 2.0 ** -8

AXES = ("mask", "cap", "carbon", "failures", "pue", "price")

#: per-lane operands, in the order the vmapped function takes them
LANE_ARGS = ("p_idle", "p_max", "r", "mask", "cap_t", "fail_start",
             "fail_end", "fail_kill", "peak_tflops", "pue_base",
             "pue_amb_coeff", "pue_amb_ref", "pue_load_coeff")


def lane_case(seed, s=4, t=41, h=19, axes=AXES):
    """Readout inputs for ``s`` lanes: host rows, caps and scalars per lane,
    the carbon, ambient and price traces shared.  Returns ``(u, lanes,
    shared)``: ``lanes`` maps each per-lane operand to its ``[S, ...]``
    array (``r`` and the scalars ``[S]``)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lanes = dict(
        p_idle=rng.uniform(40.0, 90.0, (s, h)).astype(f32),
        p_max=rng.uniform(200.0, 420.0, (s, h)).astype(f32),
        r=rng.uniform(1.2, 3.4, s).astype(f32),
        peak_tflops=rng.uniform(100.0, 500.0, s).astype(f32))
    shared = {}
    u = rng.uniform(0.0, 1.15, (s, t, h)).astype(f32)
    if "mask" in axes:
        lanes["mask"] = rng.uniform(size=(s, h)) < 0.8
    if "cap" in axes:
        rough = lanes["p_idle"].sum(1) + 0.4 * lanes["p_max"].sum(1)
        lanes["cap_t"] = (rng.uniform(0.5, 1.1, (s, t)) * rough[:, None]).astype(f32)
    if "carbon" in axes:
        shared["intensity"] = rng.uniform(50.0, 600.0, t).astype(f32)
    if "failures" in axes:
        fs = np.where(rng.uniform(size=(s, h)) < 0.4, rng.integers(0, t, (s, h)),
                      np.iinfo(np.int32).max).astype(np.int32)
        fe = np.minimum(fs.astype(np.int64) + rng.integers(3, max(t // 2, 4), (s, h)),
                        np.iinfo(np.int32).max).astype(np.int32)
        lanes.update(fail_start=fs, fail_end=fe,
                     fail_kill=rng.uniform(size=(s, h)) < 0.7)
    if "pue" in axes:
        lanes.update(pue_base=rng.uniform(1.05, 1.4, s).astype(f32),
                     pue_amb_coeff=rng.uniform(0.0, 0.05, s).astype(f32),
                     pue_amb_ref=rng.uniform(10.0, 22.0, s).astype(f32),
                     pue_load_coeff=rng.uniform(0.0, 0.25, s).astype(f32))
        shared["ambient"] = rng.uniform(-5.0, 38.0, t).astype(f32)
    if "price" in axes:
        shared["price"] = rng.uniform(-0.05, 0.45, t).astype(f32)
    return u, lanes, shared


def vmapped_pallas(u, lanes, shared, **static):
    """``jax.vmap`` of ``des_readout_pallas(interpret=True)`` over the lanes,
    the shared traces closure constants, as ``_scenario_lanes`` runs it."""
    names = [k for k in LANE_ARGS if k in lanes]

    def one(u_lane, *vals):
        return des_readout_pallas(u_lane, **dict(zip(names, vals)), **shared,
                                  **static, tb_t=64, interpret=True)

    out = jax.vmap(one)(u, *(lanes[k] for k in names))
    return {k: np.asarray(v) for k, v in out.items()}


def port(u, lanes, shared, **static):
    """``ops.des_readout`` on ``[S, T, H]``: a per-lane scalar of a host
    row (``r``) is ``[S, 1]``, the lane scalars ``[S]``."""
    kw = {k: torch.from_numpy(np.asarray(v)) for k, v in {**lanes, **shared}.items()}
    kw["r"] = kw["r"][:, None]
    return ops.des_readout(torch.from_numpy(u), **kw, **static)


def assert_close(got, want, precision="f32"):
    """``tests/test_torch_kernels.py``'s bars: rtol 1e-5, the bf16
    performance leaves within one bf16 ulp."""
    assert set(got) == set(ref.READOUT_FIELDS)
    for k in ref.READOUT_FIELDS:
        g = got[k].numpy().astype(np.float64)
        w = np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        if precision == "bf16" and k in ("tflops", "efficiency"):
            assert np.all(np.abs(g - w) <= BF16_ULP * np.abs(w)), k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)


_AXIS_CASES = [
    ((), 0), (("mask",), 1), (("cap",), 2), (("cap", "carbon"), 3),
    (("failures",), 4), (("pue",), 5), (("price",), 6), (AXES, 7),
]


@pytest.mark.parametrize("axes,seed", _AXIS_CASES,
                         ids=["+".join(a) or "plain" for a, _ in _AXIS_CASES])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lanes_match_vmapped_pallas_every_axis(axes, seed, precision):
    u, lanes, shared = lane_case(seed, axes=axes)
    want = vmapped_pallas(u, lanes, shared, precision=precision)
    got = port(u, lanes, shared, precision=precision)
    assert got["power_w"].shape == (4, 41)
    assert_close(got, want, precision)


@pytest.mark.parametrize("model", ["opendc", "linear", "sqrt", "cubic"])
def test_lanes_match_vmapped_pallas_power_models(model):
    u, lanes, shared = lane_case(11, s=3)
    assert_close(port(u, lanes, shared, model=model),
                 vmapped_pallas(u, lanes, shared, model=model))


def test_one_lane_in_three_dims_equals_the_two_dim_call():
    """S = 1 in ``[1, T, H]`` gives the ``[T, H]`` call's leaves bit for bit,
    and each lane of a batch gives the ``[T, H]`` call on its own operands."""
    u, lanes, shared = lane_case(21, s=3)
    batch = port(u, lanes, shared)
    for i in range(3):
        solo = ops.des_readout(
            torch.from_numpy(u[i]), **{k: torch.from_numpy(np.asarray(v[i]))
                                       for k, v in lanes.items()},
            **{k: torch.from_numpy(v) for k, v in shared.items()})
        one = port(u[i:i + 1], {k: v[i:i + 1] for k, v in lanes.items()}, shared)
        for k in ref.READOUT_FIELDS:
            assert solo[k].shape == (41,) and one[k].shape == (1, 41)
            assert torch.equal(one[k][0], solo[k]), k
            np.testing.assert_allclose(batch[k][i].numpy(), solo[k].numpy(),
                                       rtol=1e-6, err_msg=k)


def test_shared_operands_stay_numbers_or_stride_zero_views():
    """A number shared by every lane stays a Python number (no device
    tensor: the kernel takes it as a parameter); a row shared by the lanes
    is a stride-0 view of the caller's tensor, not a copy."""
    u = torch.rand(5, 8, 3)
    row = torch.tensor([60.0, 70.0, 80.0])
    _, operands = ops.pack_readout(u, p_idle=row, p_max=np.float32(350.0),
                                   r=torch.tensor(2.0), peak_tflops=3)
    assert operands["p_max"] == 350.0 and operands["r"] == 2.0
    assert operands["peak_tflops"] == 3.0 and operands["fail_start"] == ops.NEVER
    assert operands["cap"] == float("inf") and operands["mask"] == 1.0
    p_idle = operands["p_idle"]
    assert p_idle.shape == (5, 3) and p_idle.stride() == (0, 1)
    assert p_idle.data_ptr() == row.data_ptr()
    _, flat = ops.pack_readout(u[0], p_idle=row, p_max=350.0, r=2.0)
    assert flat["p_idle"].shape == (1, 3)


def test_mismatched_shapes_and_dtypes_are_rejected():
    u, lanes, shared = lane_case(5, s=3, t=8, h=4)
    ut = torch.from_numpy(u)
    base = dict(p_idle=70.0, p_max=350.0, r=2.0)
    bad_shapes = [
        dict(p_idle=torch.ones(3, 5)),               # hosts 5 != 4
        dict(p_idle=torch.ones(2, 4)),               # lanes 2 != 3
        dict(r=torch.ones(3)),                       # [S] is not a host row
        dict(cap_t=torch.ones(9)),                   # bins 9 != 8
        dict(intensity=torch.ones(3, 7)),
        dict(pue_base=torch.ones(4)),                # lanes 4 != 3
    ]
    for extra in bad_shapes:
        with pytest.raises(ValueError, match="does not broadcast"):
            ops.des_readout(ut, **{**base, **extra})
    with pytest.raises(ValueError, match="does not broadcast"):   # no lane axis
        ops.des_readout(ut[0], **{**base, "p_idle": torch.ones(3, 4)})
    with pytest.raises(ValueError, match=r"\[S, T, H\]"):
        ops.des_readout(ut[0, 0], **base)
    with pytest.raises(ValueError, match=r"\[S, T, H\]"):
        ops.des_readout(ut[None], **base)
    with pytest.raises(TypeError, match="floating point"):
        ops.des_readout(ut.to(torch.int32), **base)
    with pytest.raises(TypeError, match="integer"):
        ops.des_readout(ut, **base, fail_start=torch.zeros(3, 4), fail_end=2,
                        fail_kill=1.0)
    with pytest.raises(TypeError, match="integer"):
        ops.des_readout(ut, **base, fail_start=1.5)
    with pytest.raises(ValueError, match="outside int32"):
        ops.des_readout(ut, **base, fail_end=2 ** 31)
    with pytest.raises(TypeError, match="real"):
        ops.des_readout(ut, **{**base, "p_max": torch.ones(4, dtype=torch.complex64)})
    with pytest.raises(ValueError, match="unknown power model"):
        ops.des_readout(ut, **base, model="quartic")


def test_empty_lanes_and_bins_give_empty_leaves():
    for shape in ((0, 5, 3), (2, 0, 3)):
        out = ops.des_readout(torch.rand(shape), p_idle=70.0, p_max=350.0, r=2.0)
        assert all(v.shape == shape[:2] for v in out.values())


def exact_readout(u, lanes, shared, dt_seconds=300.0):
    """``_tile_readout``'s formula evaluated in float64 numpy on the same
    float32 inputs, f32 policy: the exact answer that both float32
    versions round.  Returns the 9 leaves ``[S, T]`` and the idle floor
    ``idle_floor * pue``."""
    f = np.float64
    s, t, h = u.shape
    x = u.astype(f)
    on = np.broadcast_to(np.asarray(lanes["mask"], f)[:, None, :], (s, t, h)).copy()
    if "fail_start" in lanes:
        bins = np.arange(t)[None, :, None]
        off = ((np.asarray(lanes["fail_kill"])[:, None, :] > 0)
               & (bins >= lanes["fail_start"][:, None, :])
               & (bins < lanes["fail_end"][:, None, :]))
        on[off] = 0.0
    uc = np.clip(x, 0.0, 1.0)
    r = lanes["r"].astype(f)[:, None, None]
    pi = lanes["p_idle"].astype(f)[:, None, :]
    pm = lanes["p_max"].astype(f)[:, None, :]
    shape = 2.0 * uc - np.exp(r * np.log(np.maximum(uc, 1e-30)))
    it_demand = ((pi + (pm - pi) * shape) * on).sum(-1)
    idle_floor = (pi * on).sum(-1)
    util_raw = (x * on).sum(-1) / np.maximum(on.sum(-1), 1.0)
    lane = {k: lanes[k].astype(f)[:, None] for k in
            ("peak_tflops", "pue_base", "pue_load_coeff", "pue_amb_coeff", "pue_amb_ref")}
    col = {k: np.asarray(shared[k], f)[None, :] for k in ("intensity", "ambient", "price")}
    pue = (lane["pue_base"] + lane["pue_load_coeff"] * (1.0 - np.clip(util_raw, 0.0, 1.0))
           + lane["pue_amb_coeff"] * np.maximum(col["ambient"] - lane["pue_amb_ref"], 0.0))
    demand, floor = it_demand * pue, idle_floor * pue
    cap = lanes["cap_t"].astype(f)
    power = np.minimum(demand, cap)
    throttle = np.clip((cap - floor) / np.maximum(demand - floor, 1e-9), 0.0, 1.0)
    e = power * (dt_seconds / 3600.0) / 1000.0
    util = np.where(demand > cap, util_raw * throttle, util_raw)
    tflops = util * lane["peak_tflops"]
    leaves = (power, e, tflops, util, tflops / np.maximum(e, 1e-9), e * col["intensity"],
              demand, pue, e * col["price"])
    return dict(zip(ref.READOUT_FIELDS, leaves)), floor


def test_float64_sums_are_nearer_the_exact_readout_where_the_throttle_cancels():
    """The port's plain version takes the four host sums in float64 and
    rounds them once (``ref.des_readout_ref``; the card kernel takes the
    same sums, so the two agree bit for bit); the JAX kernel's are float32
    sums.  Where a cap sits just above the idle floor, ``(cap - floor) /
    (demand - floor)`` cancels and magnifies the floor's rounding: at the
    what-if batch's shape C (16 lanes of the first 64 + 24 i of 424 hosts,
    576 bins, every axis on), every bin capped 1e-5 to 1e-2 above its exact
    floor, the plain version is nearer an exact float64 evaluation of the
    formula than the Pallas kernel in the leaves the sums reach, and equal
    to it where they do not.

    The plain version runs on one intra-op thread here: on the development
    CPU (torch 2.13.0+cpu, 8 threads) the first multithreaded ``torch.log``
    of a process at this size now and then returns values that differ from
    the next call's (seen in 1 of 12 fresh processes, moving the shape term
    by up to 2.9e-5; ROADMAP C), which would measure that, not the sums."""
    s, t, h = 16, 576, 424
    u, lanes, shared = lane_case(16, s=s, t=t, h=h)
    lanes["mask"] = np.arange(h)[None, :] < (64 + 24 * np.arange(s))[:, None]
    lanes["cap_t"] = np.full((s, t), np.inf, np.float32)
    _, floor = exact_readout(u, lanes, shared)
    above = 10.0 ** np.random.default_rng(1).uniform(-5.0, -2.0, (s, t))
    lanes["cap_t"] = (floor * (1.0 + above)).astype(np.float32)
    exact, floor = exact_readout(u, lanes, shared)
    assert np.all(exact["power_demand_w"] > lanes["cap_t"])     # every bin throttled
    assert np.all(lanes["cap_t"] > floor)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port_out = port(u, lanes, shared, dt_seconds=300.0)
    finally:
        torch.set_num_threads(threads)
    pallas_out = vmapped_pallas(u, lanes, shared, dt_seconds=300.0)

    def rel_err(got, k):
        w = exact[k]
        return float(np.mean(np.abs(np.asarray(got[k], np.float64) - w) / np.abs(w)))

    for k in ("power_demand_w", "utilization", "tflops", "efficiency"):
        mine = rel_err({k: port_out[k].numpy()}, k)
        jax_err = rel_err(pallas_out, k)
        print(f"{k}: mean relative error {mine:.3g} (float64 sums), "
              f"{jax_err:.3g} (Pallas, float32 sums)")
        assert mine < 0.9 * jax_err, (k, mine, jax_err)
    for k in ("power_w", "energy_kwh", "pue"):       # the cap, or no host sum
        np.testing.assert_allclose(port_out[k].numpy(), exact[k], rtol=1e-6, err_msg=k)
