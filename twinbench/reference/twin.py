"""A twin worked out again, window by window, and the comparison of its
outputs with it (arXiv:2604.11445 §2.3-2.4).

Each step the twin predicts its window with the parameters it carries,
scores the prediction against the measured power (MAPE), counts the SLO and
the bias, pushes the window into a history of ``history_windows`` windows and
grid-searches the candidate that minimizes the history's MAPE, which it
carries to the next window.  All of it in plain PyTorch at ``dtype``
(float64 for the reference; a lower precision makes the control).

The sums over hosts are taken once a window: for a candidate ``c`` the
predicted total is ``H p_idle_c + (p_max_c - p_idle_c) (S2_t - Sr_t(r_c))``
with ``S2_t = sum_h 2u`` and ``Sr_t(r) = sum_h u^r`` over the window's bins,
and a history's MAPE sums its windows' absolute percentage errors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from twinbench.reference import placement, readout

LEAVES = ("power_w", "energy_kwh", "tflops", "utilization", "efficiency")
EPS = 1e-9


def candidate_grid(cal: dict, base: dict) -> np.ndarray:
    """``[C, 3]`` float32 ``(p_idle, p_max, r)``: the joint grid over ``r``
    and the two scales, ``p_max`` at least ``p_idle``."""
    r = np.linspace(cal["r_lo"], cal["r_hi"], cal["r_points"], dtype=np.float32)
    if cal["mode"] == "r_only":
        c = r.shape[0]
        return np.stack([np.full(c, base["p_idle"], np.float32),
                         np.full(c, base["p_max"], np.float32), r], axis=1)
    s = np.linspace(cal["scale_lo"], cal["scale_hi"], cal["scale_points"], dtype=np.float32)
    rr, si, sm = np.meshgrid(r, s, s, indexing="ij")
    p_idle = si.ravel() * np.float32(base["p_idle"])
    p_max = np.maximum(sm.ravel() * np.float32(base["p_max"]), p_idle)
    return np.stack([p_idle, p_max, rr.ravel()], axis=1).astype(np.float32)


def week_field(week: dict, dc: dict) -> np.ndarray:
    """The week's DES utilization (worst fit, no backfill, every host)."""
    hosts = dc["num_hosts"]
    js, jh, _ = placement.place_lane(
        week["submit"], week["dur"], week["cores"], week["valid"], np.ones(hosts, bool),
        dc["cores_per_host"], placement.WORST_FIT, 0, t_bins=week["t_bins"],
        max_starts=64, max_backfill=0)
    return readout.field(js, jh, week["dur"], week["cores"], week["util"], num_hosts=hosts,
                         cores_per_host=dc["cores_per_host"], t_bins=week["t_bins"])


class Week:
    """A week's windows of ``tw`` bins and the sums the steps read, at
    ``dtype`` on ``device``: ``u`` the utilization field, ``real`` the
    measured power, ``grid`` the ``[C, 3]`` candidates."""

    def __init__(self, u: np.ndarray, real: np.ndarray, tw: int, grid: np.ndarray,
                 dtype, device):
        t, h = u.shape
        self.h, self.tw, self.w = h, tw, t // tw
        self.dtype, self.device = dtype, device
        self.u = torch.as_tensor(u[:self.w * tw], device=device).to(dtype).view(self.w, tw, h)
        self.uc = self.u.clamp(0.0, 1.0)
        self.real = torch.as_tensor(real[:self.w * tw], device=device).to(dtype).view(self.w, tw)
        self.s1 = self.u.sum(-1)
        self.s2 = (2.0 * self.uc).sum(-1)
        self.grid = grid
        self._sr: dict[float, torch.Tensor] = {}
        rs, slot = np.unique(grid[:, 2], return_inverse=True)
        sr = torch.stack([self.sr(float(r)) for r in rs], dim=-1)          # [W, Tw, R]
        slot = torch.as_tensor(slot, device=device)
        g = torch.as_tensor(grid, device=device).to(dtype)
        pi, span = g[:, 0], g[:, 1] - g[:, 0]
        nz = self.real.abs() > EPS
        self.n = nz.sum(-1)                                                 # [W]
        ape = []
        for k in range(self.w):                                             # [C] a window
            sim = self.h * pi[:, None] + span[:, None] * (self.s2[k][None, :] - sr[k][:, slot].T)
            err = ((self.real[k][None] - sim) / (self.real[k].abs()[None] + EPS)).abs()
            ape.append((err * nz[k][None]).sum(-1))
        self.ape = torch.stack(ape)                                         # [W, C]

    def sr(self, r: float) -> torch.Tensor:
        """``sum_h u^r`` of every bin, ``[W, Tw]``."""
        if r not in self._sr:
            rr = torch.tensor(np.float32(r), device=self.device).to(self.dtype)
            self._sr[r] = torch.pow(self.uc, rr).sum(-1)
        return self._sr[r]

    def predict(self, windows: np.ndarray, params: np.ndarray, peak: float) -> dict:
        """Leaves ``[N, Tw]`` of each step's window ``windows[n]`` under its
        float32 ``params[n] = (p_idle, p_max, r)``."""
        params = np.asarray(params, np.float32)
        rs, slot = np.unique(params[:, 2], return_inverse=True)
        sr = torch.stack([self.sr(float(r)) for r in rs])                   # [R, W, Tw]
        k = torch.as_tensor(windows, device=self.device)
        srn = sr[torch.as_tensor(slot, device=self.device), k]             # [N, Tw]
        p = torch.as_tensor(params, device=self.device).to(self.dtype)
        pi, pm = p[:, :1], p[:, 1:2]
        power = self.h * pi + (pm - pi) * (self.s2[k] - srn)
        e = power * (readout.SAMPLE_SECONDS / 3600.0) / 1000.0
        util = self.s1[k] / self.h
        tflops = util * peak
        return dict(power_w=power, energy_kwh=e, tflops=tflops, utilization=util,
                    efficiency=tflops / e.clamp(min=EPS))

    def mape(self, windows: np.ndarray, power: torch.Tensor) -> torch.Tensor:
        """``[N]`` MAPE of each step's predicted power against its window's."""
        real = self.real[torch.as_tensor(windows, device=self.device)]
        nz = real.abs() > EPS
        err = ((real - power) / (real.abs() + EPS)).abs() * nz
        return 100.0 * err.sum(-1) / nz.sum(-1).clamp(min=1)

    def overall_mape(self, windows: list[int], power) -> float:
        """MAPE over every bin of ``windows`` taken together, ``power``
        ``[N, Tw]`` the prediction of each."""
        real = self.real[torch.as_tensor(windows, device=self.device)].double()
        p = torch.as_tensor(np.asarray(power), device=self.device).double()
        nz = real.abs() > EPS
        err = ((real - p) / (real.abs() + EPS)).abs() * nz
        return float(100.0 * err.sum() / nz.sum().clamp(min=1))

    def history(self, windows: list[int], history: int) -> tuple[np.ndarray, np.ndarray]:
        """The calibration history after the last of ``windows``: its last
        ``history`` windows' ``[history, Tw, H]`` utilization and ``[history,
        Tw]`` power, oldest first, zeros in the slots not yet filled."""
        last = windows[-history:]
        u = np.zeros((history, self.tw, self.h))
        p = np.zeros((history, self.tw))
        u[:len(last)] = self.u[last].double().cpu().numpy()
        p[:len(last)] = self.real[last].double().cpu().numpy()
        return u, p

    def histories(self, windows: list[int], history: int):
        """Each step's calibration history (its window and up to
        ``history - 1`` before it): the distinct histories' ``[K, C]`` MAPE of
        every candidate, and each step's row."""
        keys = [tuple(windows[max(0, n - history + 1):n + 1]) for n in range(len(windows))]
        uniq = {k: i for i, k in enumerate(dict.fromkeys(keys))}
        ape = torch.stack([self.ape[list(k)].sum(0) for k in uniq])
        n = torch.stack([self.n[list(k)].sum() for k in uniq]).clamp(min=1)
        return 100.0 * ape / n[:, None], np.array([uniq[k] for k in keys])


@dataclasses.dataclass
class Served:
    """What a twin's steps gave: ``[N, 3]`` parameters used and next,
    ``[N]`` MAPE, ``[N, Tw]`` leaves, and the state after the last step."""

    params_used: np.ndarray
    params_next: np.ndarray
    mape: np.ndarray
    pred: dict
    state: dict


def _argmin_nan_last(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(m), torch.full_like(m, float("inf")), m).argmin(-1)


def follow(week: Week, windows: list[int], *, base: dict, slo_threshold: float,
           history: int, peak: float) -> Served:
    """A twin's steps over ``windows`` (the week's window of each step),
    computed at the week's dtype, choosing its own candidates.  A step's
    choice depends on its history alone, so the steps are taken together:
    each uses the parameters the step before chose."""
    w = np.asarray(windows)
    hm, row = week.histories(windows, history)
    pick = _argmin_nan_last(hm)                                            # [K]
    choice = pick.cpu().numpy()[row]
    nxt = week.grid[choice]
    used = np.concatenate([np.array([[base["p_idle"], base["p_max"], base["r"]]], np.float32),
                           nxt[:-1]])
    pred = week.predict(w, used, peak)
    mapes = week.mape(w, pred["power_w"])
    real = week.real[torch.as_tensor(w, device=week.device)]
    power = pred["power_w"]
    hist_u, hist_p = week.history(windows, history)
    state = dict(hist_u=hist_u, hist_p=hist_p,
                 hist_n=min(len(windows), history), window=len(windows),
                 slo_samples=len(windows), slo_compliant=int((mapes < slo_threshold).sum()),
                 bias_under=int((power < real).sum()), bias_over=int((power > real).sum()),
                 bias_ties=int((power == real).sum()))
    return Served(used, nxt, mapes.double().cpu().numpy(),
                  {k: v.double().cpu().numpy() for k, v in pred.items()}, state)


def rel_gap(a, b) -> float:
    """Largest ``|a - b| / |b|`` (0 where both are 0, inf where only ``b``
    is; NaN counts as inf)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.abs(b)
    diff = np.abs(a - b)
    gap = np.where(den > 0, diff / np.where(den > 0, den, 1.0), np.where(diff > 0, np.inf, 0.0))
    gap = np.where(np.isnan(gap), np.inf, gap)
    return float(gap.max()) if gap.size else 0.0


def compare(got: Served, week: Week, windows: list[int], *, base: dict, history: int,
            slo_threshold: float, peak: float, tie: float) -> dict:
    """The numbers the check holds against their limits, for one twin:
    its steps judged by the reference's ``week`` (float64).  Each
    step is predicted with the parameters the twin says it used, which
    have to be the ones it chose the step before; a choice is judged by the
    reference's MAPE of it against the grid's least (its regret).  Counts
    that a bin or a window within rounding of its threshold could tip are
    held to the range of counts the tips allow (``tie``, relative)."""
    w = np.asarray(windows)
    used = np.asarray(got.params_used, np.float32)
    nxt = np.asarray(got.params_next, np.float32)
    prev = np.concatenate([np.array([[base["p_idle"], base["p_max"], base["r"]]], np.float32),
                           nxt[:-1]])
    mism = int((used.view(np.int32) != prev.view(np.int32)).any(axis=1).sum())
    pred = week.predict(w, used, peak)
    pred_gap = max(rel_gap(got.pred[k], pred[k].cpu().numpy()) for k in LEAVES)
    m = week.mape(w, pred["power_w"]).cpu().numpy()
    mape_gap = rel_gap(got.mape, m)
    real = week.real[torch.as_tensor(w, device=week.device)].cpu().numpy()
    pw = pred["power_w"].cpu().numpy()
    band = tie * np.abs(real)
    st = got.state
    counts = int(st["hist_n"] != min(len(windows), history)) + int(st["window"] != len(windows))
    counts += int(st["slo_samples"] != len(windows))
    for value, lo, hi in (
            (st["slo_compliant"], (m < slo_threshold * (1 - tie)).sum(),
             (m < slo_threshold * (1 + tie)).sum()),
            (st["bias_under"], (pw < real - band).sum(), (pw < real + band).sum()),
            (st["bias_over"], (pw > real + band).sum(), (pw > real - band).sum()),
            (st["bias_ties"], 0, (np.abs(pw - real) <= band).sum())):
        counts += int(not lo <= value <= hi)
    index = {tuple(row.view(np.int32)): c for c, row in enumerate(week.grid)}
    choice = np.array([index.get(tuple(row.view(np.int32)), -1) for row in nxt])
    mism += int((choice < 0).sum())
    hm, row = week.histories(windows, history)
    hm = hm.cpu().numpy()
    ok = choice >= 0
    least = np.nanmin(hm, axis=1)[row[ok]]
    chosen = hm[row[ok], choice[ok]]
    regret = float(((chosen - least) / least).max()) if ok.any() else 0.0
    hist_u, hist_p = week.history(windows, history)
    field_gap = float(np.abs(np.asarray(st["hist_u"], np.float64) - hist_u).max())
    tele_gap = rel_gap(st["hist_p"], hist_p)
    return dict(params_mismatches=mism, prediction_rel_gap=pred_gap, mape_rel_gap=mape_gap,
                calib_regret=regret, state_mismatches=counts, history_abs_gap=field_gap,
                telemetry_rel_gap=tele_gap)
