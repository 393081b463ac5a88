"""The twin core: ``TwinState`` + ``twin_step`` (port of ``repro.core.state``).

The paper's continuous integration cycle (§2.3) as a state-transition
function:

    state', output = twin_step(state, telemetry, sim_slice)

predict the window with the pipelined parameters, score it against
telemetry, update the SLO and bias counts, and grid-search the power-model
parameters over the calibration history for the next window.  The state
is a dataclass of tensors on ``TwinConfig.device``; ``twin_step`` returns a
new state and leaves its input untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.calibrate import CalibrationSpec, calibrate_traced, candidate_grid
from repro_torch.core.desim import Prediction, predict_metrics
from repro_torch.core.power import PowerParams, mape
from repro_torch.core.slo import NFR1, SLO, observe_bias, observe_slos
from repro_torch.traces.schema import DatacenterConfig
from repro_torch.traces.thermal import PUEParams

Tensor = torch.Tensor


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
    valid: bool


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
