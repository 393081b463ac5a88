"""Each driver end to end at a tiny size on the port's plain kernels (the
look for a card skipped): its outputs pass the check against the reference,
the reference computed in bfloat16 (the control) fails it, and each fault the
cell can have, planted under the timed path, makes ``correct`` false."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from twinbench.drivers import replay, whatif
from twinbench.harness import seeds, surf22
from twinbench.reference import twin as ref
from twinbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 987654321


def run(mod, cell, seconds=0.4):
    return mod.run(cell, seed=SEED, seconds=seconds, traced=False, device=CPU, t_start=0.0)


def test_whatif_tiny_is_correct_and_reports_its_metrics():
    cell = tiny.whatif_cell()
    out = run(whatif, cell, seconds=1.0)
    assert out.checks.passed, out.checks.items
    assert out.checks.items["placement_mismatches"]["value"] == 0
    assert set(out.metrics) == {"whatif_scenarios_per_s", "whatif_p95_ms", "setup_s"}
    assert out.attempted >= 1 and out.metrics["whatif_scenarios_per_s"] > 0
    assert len(out.run["launches"]["des_place"]) == out.attempted


def test_whatif_control_in_bfloat16_fails():
    cell = tiny.whatif_cell()
    cfg, tr = cell.config, cell.traffic
    weeks = [surf22.make_week(cfg["trace"], cfg["datacenter"], seeds.derive(SEED, seeds.WEEKS, i))
             for i in range(tr["pool_weeks"])]
    items = [(n, None, None, None, None) for n in range(tr["check"]["requests"])]
    checks = whatif.check(items, weeks, whatif.lanes_of(tr), cfg, tr, SEED,
                          control=torch.bfloat16)
    assert not checks.passed
    assert checks.items["prediction_rel_gap"]["value"] > 30 * tr["check"]["limits"][
        "prediction_rel_gap"]


def _half_left_out(real):
    def run_scenarios(*a, **k):
        sim, pred = real(*a, **k)
        s = sim.job_start.shape[0] // 2

        def fill(x):
            if x is None:
                return None
            x = x.clone()
            x[s:2 * s] = x[:s]
            return x
        return (type(sim)(*(fill(getattr(sim, f.name)) for f in dataclasses.fields(sim))),
                type(pred)(*(fill(getattr(pred, f.name)) for f in dataclasses.fields(pred))))
    return run_scenarios


def _host_altered(real):
    def des_place(*a, **k):
        start, host, att = real(*a, **k)
        host = host.clone()
        first = (start >= 0).int().argmax(dim=1)
        lanes = torch.arange(host.shape[0])
        host[lanes, first] = (host[lanes, first] + 1) % 4
        return start, host, att
    return des_place


@pytest.mark.parametrize("fault", ["half_the_batch_left_out", "an_answer_altered"])
def test_whatif_fault_under_the_timed_path_is_caught(monkeypatch, fault):
    import repro_torch.core.scenarios as sc
    import repro_torch.kernels.ops as ops
    if fault == "half_the_batch_left_out":
        monkeypatch.setattr(sc, "run_scenarios", _half_left_out(sc.run_scenarios))
    else:
        monkeypatch.setattr(ops, "des_place", _host_altered(ops.des_place))
    out = run(whatif, tiny.whatif_cell(), seconds=1.0)
    assert not out.checks.passed, out.checks.items


def test_replay_tiny_is_correct_and_reports_its_metrics():
    cell = tiny.replay_cell()
    out = run(replay, cell, seconds=1.0)
    assert out.checks.passed, out.checks.items
    assert out.checks.items["replays_short"]["value"] == 0
    assert set(out.metrics) == {"e2_windows_per_s", "e2_week_p95_ms", "setup_s"}
    assert out.attempted >= 1
    assert out.run["units"] == out.attempted * 8 == len(out.run["launches"]["calib_mape"])


def test_replay_control_in_bfloat16_fails():
    cell = tiny.replay_cell()
    cfg, tr = cell.config, cell.traffic
    weeks = [surf22.make_week(cfg["trace"], cfg["datacenter"], seeds.derive(SEED, seeds.WEEKS, i))
             for i in range(tr["pool_weeks"])]
    checks = replay.check([(0, None), (1, None)], weeks, 8, cfg, tr, SEED, dtype=torch.bfloat16)
    assert not checks.passed
    lim = tr["check"]["limits"]
    assert checks.items["prediction_rel_gap"]["value"] > 30 * lim["prediction_rel_gap"]


def _unchanged(real):
    def step(state, *a, **k):
        _, out = real(state, *a, **k)
        return state, out
    return step


def _half_scored(real):
    def mape(r, s, *a, **k):
        half = r.shape[-1] // 2
        return real(r[..., :half], s[..., :half], *a, **k)
    return mape


def _first_candidate(real):
    def calibrate(u, p, cand, spec, base):
        params, best = real(u, p, cand, spec, base)
        return type(params)(*(x[0].reshape(getattr(params, f).shape) for x, f in
                              zip((cand.p_idle, cand.p_max, cand.r),
                                  ("p_idle", "p_max", "r")))), best
    return calibrate


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch_left_out",
                                   "an_answer_altered"])
def test_replay_fault_under_the_timed_path_is_caught(monkeypatch, fault):
    import repro_torch.core.orchestrator as orch
    import repro_torch.core.state as st
    if fault == "state_unchanged":
        monkeypatch.setattr(orch, "twin_step", _unchanged(orch.twin_step))
    elif fault == "half_the_batch_left_out":
        monkeypatch.setattr(st, "mape", _half_scored(st.mape))
    else:
        monkeypatch.setattr(st, "calibrate_traced", _first_candidate(st.calibrate_traced))
    out = run(replay, tiny.replay_cell(), seconds=1.0)
    assert out.checks.items["replays_short"]["value"] == 0
    assert not out.checks.passed, out.checks.items


def test_overall_mape_takes_every_bin_of_the_windows_together():
    rng = np.random.default_rng(5)
    u = rng.random((72, 4)).astype(np.float32)
    real = (rng.random(72) * 100 + 50).astype(np.float32)
    grid = np.array([[70.0, 350.0, 2.0]], np.float32)
    week = ref.Week(u, real, 36, grid, torch.float64, "cpu")
    assert week.overall_mape([0, 1], real.reshape(2, 36)) == 0.0
    power = real.reshape(2, 36) * np.array([[1.1], [0.8]])
    per_window = week.mape(np.array([0, 1]), torch.as_tensor(power)).numpy()
    assert week.overall_mape([0, 1], power) == pytest.approx(per_window.mean(), rel=1e-12)
    assert week.overall_mape([1], power[1:]) == pytest.approx(20.0, rel=1e-9)
