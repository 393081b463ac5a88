"""The twin core: ``TwinState`` + ``twin_step`` (port of ``repro.core.state``).

The paper's continuous integration cycle (§2.3) as a state-transition
function:

    state', output = twin_step(state, telemetry, sim_slice)

predict the window with the pipelined parameters, score it against
telemetry, update the SLO and bias counts, and grid-search the power-model
parameters over the calibration history for the next window.  The state
is a dataclass of tensors on ``TwinConfig.device``; ``twin_step`` returns a
new state and leaves its input untouched.

:func:`twin_step_lanes` is the same window for a fleet of D twins whose
leaves lead with ``[D]`` (the JAX package's ``jax.vmap(twin_step)``, the
lane axis written out): one readout launch and one calibration launch a
round for all lanes, masked per lane on the device.  A state round-trips
through bytes (:func:`state_to_bytes`, :func:`save_state`) bit for bit,
in the JAX package's wire format.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import codec
from repro_torch.core.calibrate import (
    CalibrationSpec,
    calibrate_traced,
    calibrate_traced_lanes,
    candidate_grid,
)
from repro_torch.core.desim import Prediction, predict_metrics
from repro_torch.core.power import PowerParams, mape
from repro_torch.core.slo import (
    NFR1,
    SLO,
    observe_bias,
    observe_bias_lanes,
    observe_slos,
    observe_slos_lanes,
)
from repro_torch.traces.schema import DatacenterConfig
from repro_torch.traces.thermal import PUEParams

Tensor = torch.Tensor

#: persisted-state format version, the JAX package's
_STATE_VERSION = 1

#: what the wire format's ``kernel_backend`` key carries: the JAX
#: package's default; the port keeps the device in ``TwinConfig.device``
#: and takes it from the caller on load
WIRE_KERNEL_BACKEND = "xla"


@dataclasses.dataclass(frozen=True)
class TwinConfig:
    """Static configuration of the core (hashable).

    ``device`` takes the place of the JAX package's ``kernel_backend``:
    the state lives there, and the kernels follow it (the hand-written
    kernels on ``"cuda"``, their plain versions on ``"cpu"``).
    """

    bins_per_window: int = 36
    dc: DatacenterConfig = DatacenterConfig()
    calibration: CalibrationSpec = CalibrationSpec()
    calibrate: bool = True
    history_windows: int = 4
    power_model: str = "opendc"
    device: str = "cuda"
    slos: tuple[SLO, ...] = (NFR1,)
    pue: PUEParams | None = None
    #: full-horizon DES resident in the state: when positive, ``TwinState``
    #: carries a ``[sim_bins, H]`` utilization field (``sim_u``) and
    #: ``twin_step`` slices its own window from it when the caller passes
    #: ``SimSlice(u_th=None)``; 0 keeps the shell feeding window slices.
    sim_bins: int = 0


@dataclasses.dataclass(frozen=True)
class TwinState:
    """Everything the windowed cycle carries between windows.

    ``params``/``base_params`` are 0-d float32 tensors (``[H]`` rows with
    ``CalibrationSpec(per_host=True)``); ``cand`` holds the ``[C]``
    candidate grid; ``hist_u [K, Tw, H]`` / ``hist_p [K, Tw]`` the
    chronological calibration history (zero-padded at the tail);
    ``hist_n``, ``window``, the bias counts are 0-d int32 tensors and
    ``slo_samples``/``slo_compliant`` ``[n_slo]`` int32 tensors;
    ``sim_u`` the ``[sim_bins, H]`` float32 DES utilization field, ``None``
    unless ``cfg.sim_bins > 0``.
    """

    params: PowerParams
    base_params: PowerParams
    cand: PowerParams
    hist_u: Tensor
    hist_p: Tensor
    hist_n: Tensor
    window: Tensor
    slo_samples: Tensor
    slo_compliant: Tensor
    bias_under: Tensor
    bias_over: Tensor
    bias_ties: Tensor
    sim_u: Tensor | None = None
    cfg: TwinConfig = TwinConfig()


@dataclasses.dataclass(frozen=True)
class TelemetrySlice:
    """One window of physical-twin telemetry on the core's device.

    With ``valid=False`` the step still predicts but scores nothing, learns
    nothing and leaves every accumulator untouched.
    """

    u_th: Tensor      # [Tw, H] float32 measured utilization
    power_w: Tensor   # [Tw] float32 measured total power
    valid: "bool | Tensor"   # a [D] bool tensor for a fleet (twin_step_lanes)


def make_telemetry(u_th, power_w, valid: bool = True,
                   device: "str | torch.device" = "cuda") -> TelemetrySlice:
    """Build a :class:`TelemetrySlice` from host arrays (float32 copies)."""
    dev = resolve_device(device)
    return TelemetrySlice(
        u_th=torch.tensor(np.asarray(u_th, np.float32), device=dev),
        power_w=torch.tensor(np.asarray(power_w, np.float32), device=dev),
        valid=bool(valid))


def empty_telemetry(bins_per_window: int, num_hosts: int,
                    device: "str | torch.device" = "cuda") -> TelemetrySlice:
    """The ``valid=False`` placeholder for a window with no telemetry."""
    dev = resolve_device(device)
    return TelemetrySlice(
        u_th=torch.zeros((bins_per_window, num_hosts), device=dev),
        power_w=torch.zeros((bins_per_window,), device=dev),
        valid=False)


@dataclasses.dataclass(frozen=True)
class SimSlice:
    """The simulation engine's window slice the core predicts from.

    ``u_th`` is the window's ``[Tw, H]`` slice of the DES utilization field;
    with ``TwinConfig.sim_bins > 0`` it may be ``None``, and ``twin_step``
    slices the window from ``state.sim_u`` itself.  ``carbon_intensity`` /
    ``ambient_c`` / ``price`` are optional ``[Tw]`` forecast slices.
    """

    u_th: Tensor | None = None
    carbon_intensity: Tensor | None = None
    ambient_c: Tensor | None = None
    price: Tensor | None = None


@dataclasses.dataclass(frozen=True)
class WindowOutput:
    """Per-window read-out of one ``twin_step``.

    ``mape`` and ``calib_mape`` are NaN when the window had no valid
    telemetry; ``params_used`` ran the prediction, ``params_next`` go to
    the next window.
    """

    prediction: Prediction
    mape: Tensor
    calib_mape: Tensor
    params_used: PowerParams
    params_next: PowerParams
    window: Tensor


def _scalar_param(x, name: str, dev: torch.device,
                  hosts: int | None = None) -> Tensor:
    """Base-parameter leaf: 0-d, or a ``[hosts]`` row in per-host mode."""
    a = torch.as_tensor(x, dtype=torch.float32).detach().to(dev)
    if hosts is not None:
        if a.dim() == 0 or a.numel() == 1:
            return a.reshape(()).expand(hosts).clone()
        if tuple(a.shape) != (hosts,):
            raise ValueError(
                f"per-host base params must be scalar or [{hosts}]; "
                f"{name} has shape {tuple(a.shape)}")
        return a.clone()
    if a.dim() != 0 and a.numel() != 1:
        raise ValueError(
            f"base params must be scalar; {name} has shape "
            f"{tuple(a.shape)}.  Per-host parameters need "
            "CalibrationSpec(per_host=True), which carries [H] rows.")
    return a.reshape(()).clone()


def init_twin_state(cfg: TwinConfig,
                    base_params: PowerParams = PowerParams(),
                    sim_u=None) -> TwinState:
    """Fresh ``TwinState`` on ``cfg.device``: base parameters, empty history.

    The candidate grid is built host-side once (:func:`candidate_grid`) and
    carried in the state.  With ``cfg.sim_bins > 0`` the state carries the
    full-horizon DES utilization field: pass ``sim_u`` (``[sim_bins, H]``)
    to seed it, or leave it ``None`` for a zero field.
    """
    dev = resolve_device(cfg.device)
    k, tw, h = cfg.history_windows, cfg.bins_per_window, cfg.dc.num_hosts
    hosts = h if cfg.calibration.per_host else None
    base = PowerParams(
        p_idle=_scalar_param(base_params.p_idle, "p_idle", dev, hosts),
        p_max=_scalar_param(base_params.p_max, "p_max", dev, hosts),
        r=_scalar_param(base_params.r, "r", dev, hosts))
    if cfg.sim_bins > 0:
        if sim_u is None:
            sim_u = torch.zeros((cfg.sim_bins, h), device=dev)
        else:
            sim_u = torch.as_tensor(sim_u, dtype=torch.float32).to(dev).clone()
            if tuple(sim_u.shape) != (cfg.sim_bins, h):
                raise ValueError(
                    f"sim_u must be [{cfg.sim_bins}, {h}] "
                    f"(cfg.sim_bins x num_hosts); got {tuple(sim_u.shape)}")
    elif sim_u is not None:
        raise ValueError("sim_u given but cfg.sim_bins == 0")
    i32 = dict(dtype=torch.int32, device=dev)
    return TwinState(
        sim_u=sim_u,
        params=PowerParams(*(x.clone() for x in (base.p_idle, base.p_max, base.r))),
        base_params=base,
        cand=candidate_grid(cfg.calibration, base, device=dev),
        hist_u=torch.zeros((k, tw, h), device=dev),
        hist_p=torch.zeros((k, tw), device=dev),
        hist_n=torch.zeros((), **i32),
        window=torch.zeros((), **i32),
        slo_samples=torch.zeros((len(cfg.slos),), **i32),
        slo_compliant=torch.zeros((len(cfg.slos),), **i32),
        bias_under=torch.zeros((), **i32),
        bias_over=torch.zeros((), **i32),
        bias_ties=torch.zeros((), **i32),
        cfg=cfg,
    )


def _push(buf: Tensor, new: Tensor, n: int) -> Tensor:
    """Append ``new`` to a chronological ``[K, ...]`` buffer (a new tensor).

    Writes at slot ``n`` while the buffer is filling and shifts left once
    full, so the buffer always reads oldest -> newest.
    """
    k = buf.shape[0]
    if n >= k:
        return torch.cat([buf[1:], new[None]], dim=0)
    out = buf.clone()
    out[n] = new
    return out


def twin_step(state: TwinState, telemetry: TelemetrySlice,
              sim_slice: SimSlice) -> tuple[TwinState, WindowOutput]:
    """One window of the continuous twinning cycle (paper Fig. 3).

    S_k: predict the window with the pipelined parameters
    (``state.params``), from ``sim_slice.u_th`` or, when that is ``None``,
    from the window's slice of ``state.sim_u``.  With valid telemetry:
    score the prediction (MAPE), update the SLO and bias counts, push the
    observation into the history and run C_k, the grid-search calibration,
    so S_{k+1} predicts with fresh parameters.
    """
    cfg = state.cfg
    params = state.params
    u_win = sim_slice.u_th
    if u_win is None:
        if state.sim_u is None:
            raise ValueError(
                "SimSlice.u_th is None but the state carries no sim_u "
                "(TwinConfig.sim_bins == 0)")
        # the window's own slice, its start clamped into the field as
        # ``lax.dynamic_slice`` clamps it; indexed on the device, no read
        tw = cfg.bins_per_window
        start = (state.window.long() * tw).clamp(0, cfg.sim_bins - tw)
        u_win = state.sim_u.index_select(
            0, start + torch.arange(tw, device=state.sim_u.device))
    pred = predict_metrics(u_win, params, cfg.dc,
                           model=cfg.power_model,
                           carbon_intensity=sim_slice.carbon_intensity,
                           ambient_c=sim_slice.ambient_c,
                           price=sim_slice.price,
                           pue=cfg.pue)

    valid = bool(telemetry.valid)
    nan = torch.full((), float("nan"), device=pred.power_w.device)
    m = mape(telemetry.power_w, pred.power_w) if valid else nan
    slo_samples, slo_compliant = observe_slos(
        cfg.slos, state.slo_samples, state.slo_compliant, m, valid,
        metric="mape")
    under, over, ties = observe_bias(
        state.bias_under, state.bias_over, state.bias_ties,
        telemetry.power_w, pred.power_w, valid)

    hist_u, hist_p, hist_n = state.hist_u, state.hist_p, state.hist_n
    params_next = params
    calib_mape = nan
    if cfg.calibrate and valid:
        n = int(state.hist_n)
        hist_u = _push(state.hist_u, telemetry.u_th, n)
        hist_p = _push(state.hist_p, telemetry.power_w, n)
        hist_n = torch.clamp(state.hist_n + 1, max=cfg.history_windows)
        k, tw, h = hist_u.shape
        params_next, calib_mape = calibrate_traced(
            hist_u.reshape(k * tw, h), hist_p.reshape(k * tw),
            state.cand, cfg.calibration, state.base_params)

    new_state = dataclasses.replace(
        state, params=params_next, hist_u=hist_u, hist_p=hist_p,
        hist_n=hist_n, window=state.window + 1, slo_samples=slo_samples,
        slo_compliant=slo_compliant, bias_under=under, bias_over=over,
        bias_ties=ties)
    out = WindowOutput(prediction=pred, mape=m, calib_mape=calib_mape,
                       params_used=params, params_next=params_next,
                       window=state.window)
    return new_state, out


# -- a fleet of twins: the lane axis written out ------------------------------

def _lane_row(x: Tensor) -> Tensor:
    """A lane's power parameter as the readout takes a host row: ``[D, 1]``
    for a per-lane scalar, ``[D, H]`` rows as they are."""
    return x if x.dim() == 2 else x[:, None]


def _lane_where(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """``where`` over leaves leading with ``[D]``: ``cond`` ``[D]`` broadcast
    over the trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _push_lanes(buf: Tensor, new: Tensor, n: Tensor) -> Tensor:
    """:func:`_push` for D lanes at once: each lane's ``[K, ...]`` buffer
    takes its ``new`` at slot ``n[d]`` while filling and shifts left once
    full, chosen on the device (a new tensor)."""
    k = buf.shape[1]
    shifted = torch.cat([buf[:, 1:], new[:, None]], dim=1)
    written = buf.clone()
    lanes = torch.arange(buf.shape[0], device=buf.device)
    written[lanes, n.clamp(max=k - 1).long()] = new
    return _lane_where(n >= k, shifted, written)


def twin_step_lanes(state: TwinState, telemetry: TelemetrySlice,
                    sim_slice: SimSlice,
                    lane_active: Tensor | None = None
                    ) -> tuple[TwinState, WindowOutput]:
    """One window of D independent twins: :func:`twin_step` lane by lane.

    ``state`` leaves lead with ``[D]`` (see
    :func:`repro_torch.core.twin.stack_twin_states`); ``telemetry`` holds
    ``u_th [D, Tw, H]``, ``power_w [D, Tw]`` and a ``[D]`` bool tensor
    ``valid``; ``sim_slice`` leaves are ``[D, ...]`` (``u_th=None`` slices
    each lane's window from ``state.sim_u``).  Every lane is predicted by
    one ``des_readout`` launch and calibrated by ``1 + refine_iters``
    ``calib_mape_grid`` launches (one more with ``per_host``), whatever
    the lanes hold; a lane without valid telemetry learns nothing and keeps
    its counts, selected on the device, with no read on the host.

    ``lane_active`` (``[D]`` bool, default all) marks the lanes that
    advance: an inactive lane's state comes back unchanged, bit for bit,
    and its outputs are padding.  Outputs lead with ``[D]``.  Each active
    lane computes what :func:`twin_step` computes for it alone.
    """
    cfg = state.cfg
    params = state.params
    u_win = sim_slice.u_th
    if u_win is None:
        if state.sim_u is None:
            raise ValueError(
                "SimSlice.u_th is None but the state carries no sim_u "
                "(TwinConfig.sim_bins == 0)")
        tw, h = cfg.bins_per_window, state.sim_u.shape[-1]
        start = (state.window.long() * tw).clamp(0, cfg.sim_bins - tw)
        bins = start[:, None] + torch.arange(tw, device=start.device)
        u_win = state.sim_u.gather(1, bins[:, :, None].expand(-1, -1, h))
    lanes = PowerParams(p_idle=_lane_row(params.p_idle),
                        p_max=_lane_row(params.p_max), r=_lane_row(params.r))
    pred = predict_metrics(u_win, lanes, cfg.dc, model=cfg.power_model,
                           carbon_intensity=sim_slice.carbon_intensity,
                           ambient_c=sim_slice.ambient_c,
                           price=sim_slice.price, pue=cfg.pue)

    dev = pred.power_w.device
    valid = torch.as_tensor(telemetry.valid, dtype=torch.bool,
                            device=dev).expand(state.window.shape)
    nan = torch.full(state.window.shape, float("nan"), device=dev)
    m = torch.where(valid, mape(telemetry.power_w, pred.power_w, dim=-1), nan)
    slo_samples, slo_compliant = observe_slos_lanes(
        cfg.slos, state.slo_samples, state.slo_compliant, m, valid,
        metric="mape")
    under, over, ties = observe_bias_lanes(
        state.bias_under, state.bias_over, state.bias_ties,
        telemetry.power_w, pred.power_w, valid)

    hist_u, hist_p, hist_n = state.hist_u, state.hist_p, state.hist_n
    params_next = params
    calib_mape = nan
    if cfg.calibrate:
        hist_u = _lane_where(valid, _push_lanes(state.hist_u, telemetry.u_th,
                                                state.hist_n), state.hist_u)
        hist_p = _lane_where(valid, _push_lanes(state.hist_p, telemetry.power_w,
                                                state.hist_n), state.hist_p)
        hist_n = torch.where(
            valid, torch.clamp(state.hist_n + 1, max=cfg.history_windows),
            state.hist_n)
        d, k, tw, h = hist_u.shape
        new_params, best_mape = calibrate_traced_lanes(
            hist_u.reshape(d, k * tw, h), hist_p.reshape(d, k * tw),
            state.cand, cfg.calibration, state.base_params)
        params_next = PowerParams(
            *(_lane_where(valid, a, b) for a, b in
              ((new_params.p_idle, params.p_idle), (new_params.p_max, params.p_max),
               (new_params.r, params.r))))
        calib_mape = torch.where(valid, best_mape, nan)

    stepped = dataclasses.replace(
        state, params=params_next, hist_u=hist_u, hist_p=hist_p,
        hist_n=hist_n, window=state.window + 1, slo_samples=slo_samples,
        slo_compliant=slo_compliant, bias_under=under, bias_over=over,
        bias_ties=ties)
    if lane_active is not None:
        active = torch.as_tensor(lane_active, dtype=torch.bool,
                                 device=state.window.device)
        stepped = _map_state(lambda new, old: _lane_where(active, new, old),
                             stepped, state)
    out = WindowOutput(prediction=pred, mape=m, calib_mape=calib_mape,
                       params_used=params, params_next=params_next,
                       window=state.window)
    return stepped, out


# -- leaves: the JAX package's flatten order ----------------------------------

#: TwinState's fields after the three PowerParams groups, in leaf order
COUNT_FIELDS = ("hist_u", "hist_p", "hist_n", "window", "slo_samples",
                "slo_compliant", "bias_under", "bias_over", "bias_ties")
_PARAM_GROUPS = ("params", "base_params", "cand")
_PARAM_FIELDS = ("p_idle", "p_max", "r")
#: every leaf's name in the JAX package's flatten order (``sim_u`` last,
#: present only with ``cfg.sim_bins > 0``)
LEAF_NAMES = tuple(f"{g}.{f}" for g in _PARAM_GROUPS for f in _PARAM_FIELDS) \
    + COUNT_FIELDS + ("sim_u",)
_INT_FIELDS = COUNT_FIELDS[2:]


def state_leaf_names(state: TwinState) -> list[str]:
    """Names of the state's leaves, in :func:`state_leaves` order."""
    return list(LEAF_NAMES[:19 if state.sim_u is not None else 18])


def state_leaves(state: TwinState) -> list:
    """The state's leaves in the JAX package's flatten order (18, or 19
    with ``sim_u``): the order of its checkpoints and digests."""
    leaves = [getattr(getattr(state, g), f)
              for g in _PARAM_GROUPS for f in _PARAM_FIELDS]
    leaves += [getattr(state, f) for f in COUNT_FIELDS]
    return leaves + ([state.sim_u] if state.sim_u is not None else [])


def _map_state(fn, *states: TwinState) -> TwinState:
    """A state whose every leaf is ``fn`` of the states' leaves."""
    leaves = [fn(*xs) for xs in zip(*(state_leaves(s) for s in states))]
    return state_with_leaves(leaves, states[0].cfg)


def state_with_leaves(leaves: list, cfg: TwinConfig) -> TwinState:
    """A :class:`TwinState` of ``leaves`` in :func:`state_leaves` order, as
    they are: tensors, or numpy arrays for a view on the host."""
    group = lambda i: PowerParams(*leaves[3 * i:3 * i + 3])  # noqa: E731
    rest = dict(zip(COUNT_FIELDS, leaves[9:18]))
    return TwinState(params=group(0), base_params=group(1), cand=group(2),
                     sim_u=leaves[18] if len(leaves) == 19 else None,
                     cfg=cfg, **rest)


def state_from_leaves(leaves, cfg: TwinConfig) -> TwinState:
    """A :class:`TwinState` on ``cfg.device`` from numpy-readable leaves in
    :func:`state_leaves` order: float32, with the counts int32.

    The leaves are one twin's, or a fleet's with a leading ``[D]`` axis
    (read from ``hist_u``: ``[K, Tw, H]`` or ``[D, K, Tw, H]``).
    """
    leaves = [np.asarray(x) for x in leaves]
    want = 19 if cfg.sim_bins > 0 else 18
    if len(leaves) != want:
        raise ValueError(f"expected {want} state leaves "
                         f"(cfg.sim_bins={cfg.sim_bins}), got {len(leaves)}")
    lead = leaves[9].shape[:-3]
    if want == 19 and leaves[18].shape != lead + (cfg.sim_bins, cfg.dc.num_hosts):
        raise ValueError(f"sim_u must be {list(lead) + [cfg.sim_bins, cfg.dc.num_hosts]}; "
                         f"got {list(leaves[18].shape)}")
    dev = resolve_device(cfg.device)
    return state_with_leaves(
        [torch.as_tensor(np.array(x, dtype=np.int32 if n in _INT_FIELDS
                                  else np.float32), device=dev)
         for n, x in zip(LEAF_NAMES, leaves)], cfg)


# -- checkpoint / resume ------------------------------------------------------

def state_to_bytes(state: TwinState) -> bytes:
    """Encode a ``TwinState`` as a codec-tagged compressed MessagePack blob.

    The JAX package's wire format (version 1): the config, then every leaf
    as a :func:`~repro_torch.core.codec.pack_array` record in
    :func:`state_leaves` order.  The one key the port fills otherwise is
    ``kernel_backend``, which holds :data:`WIRE_KERNEL_BACKEND`: the device
    is not part of the blob.  Under the zlib codec the bytes are those the
    JAX package writes for the same state.  Leaves may be tensors (copied
    to the host, one copy a leaf) or numpy arrays.
    """
    cfg = state.cfg
    payload = {
        "version": _STATE_VERSION,
        "cfg": {
            "bins_per_window": cfg.bins_per_window,
            "dc": dataclasses.asdict(cfg.dc),
            "calibration": dataclasses.asdict(cfg.calibration),
            "calibrate": cfg.calibrate,
            "history_windows": cfg.history_windows,
            "power_model": cfg.power_model,
            "kernel_backend": WIRE_KERNEL_BACKEND,
            "slos": [dataclasses.asdict(s) for s in cfg.slos],
            "pue": (dataclasses.asdict(cfg.pue)
                    if cfg.pue is not None else None),
            "sim_bins": cfg.sim_bins,
        },
        "leaves": [codec.pack_array(x) for x in state_leaves(state)],
    }
    return codec.dumps(payload)


def state_from_bytes(blob: bytes, device: "str | torch.device" = "cuda") -> TwinState:
    """Decode a ``TwinState`` from :func:`state_to_bytes` (or from the JAX
    package's blob) onto ``device``, bit for bit.

    The blob's ``kernel_backend`` is ignored: ``TwinConfig.device`` is
    ``device``.
    """
    payload = codec.loads(blob)
    if payload["version"] != _STATE_VERSION:
        raise ValueError(
            f"unsupported TwinState version {payload['version']} "
            f"(this build reads {_STATE_VERSION})")
    c = payload["cfg"]
    cfg = TwinConfig(
        bins_per_window=c["bins_per_window"],
        dc=DatacenterConfig(**c["dc"]),
        calibration=CalibrationSpec(**c["calibration"]),
        calibrate=c["calibrate"],
        history_windows=c["history_windows"],
        power_model=c["power_model"],
        device=str(device),
        slos=tuple(SLO(**s) for s in c["slos"]),
        pue=(PUEParams(**c["pue"]) if c.get("pue") is not None else None),
        sim_bins=c.get("sim_bins", 0),
    )
    return state_from_leaves([codec.unpack_array(rec) for rec in payload["leaves"]],
                             cfg)


def save_state(state: TwinState, path: str) -> None:
    """Persist a ``TwinState`` (:func:`state_to_bytes`) to ``path``."""
    with open(path, "wb") as f:
        f.write(state_to_bytes(state))


def load_state(path: str, device: "str | torch.device" = "cuda") -> TwinState:
    """Load a ``TwinState`` written by :func:`save_state` (or by the JAX
    package) onto ``device``; a resumed run reproduces the uninterrupted
    run exactly."""
    with open(path, "rb") as f:
        return state_from_bytes(f.read(), device=device)
