"""The plain reference against the port's own plain versions on the CPU,
the copied trace generator against the port's, and the reference's
independence: it loads nothing of the port, the JAX package or JAX."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from twinbench.harness import files, surf22
from twinbench.reference import placement, readout

TRACE = files.load("configs", "surf-lisa-277")["trace"]


def _case(seed, hosts=9, t_bins=40, fail=False):
    dc = {"num_hosts": hosts, "cores_per_host": 8}
    week = surf22.make_week(dict(TRACE, days=t_bins / 288, target_utilization=0.5), dc, seed)
    mask = np.arange(hosts) < hosts - 2
    rows = None
    if fail:
        fs = np.full(hosts, placement.NEVER_BIN, np.int64)
        fe = np.zeros(hosts, np.int64)
        fk = np.zeros(hosts, bool)
        fs[:3], fe[:3], fk[:2] = 10, 20, True
        rows = (fs, fe, fk)
    return week, mask, rows


@pytest.mark.parametrize("policy", range(4))
@pytest.mark.parametrize("depth,fail", [(0, False), (3, False), (3, True)])
def test_placement_equals_the_ports_plain_version(policy, depth, fail):
    from repro_torch.kernels.ref import des_place_ref
    week, mask, rows = _case(100 + policy, fail=fail)
    t = week["t_bins"]
    js, jh, att = placement.place_lane(week["submit"], week["dur"], week["cores"], week["valid"],
                                       mask, 8, policy, depth, t_bins=t, max_starts=6,
                                       max_backfill=4, fail=rows)
    lane = lambda a, dt: torch.as_tensor(np.asarray(a)[None]).to(dt)  # noqa: E731
    kw = {} if rows is None else dict(fail_start=lane(rows[0], torch.int32),
                                      fail_end=lane(rows[1], torch.int32),
                                      fail_kill=lane(rows[2], torch.bool))
    want = des_place_ref(lane(week["submit"], torch.int32), lane(week["dur"], torch.int32),
                         lane(week["cores"], torch.int32), lane(week["valid"], torch.bool),
                         lane(mask, torch.bool), torch.tensor([8]), torch.tensor([policy]),
                         torch.tensor([depth]), t_bins=t, max_starts_per_bin=6, max_backfill=4,
                         **kw)
    assert np.array_equal(js, want[0][0].numpy()) and np.array_equal(jh, want[1][0].numpy())
    assert att == int(want[2][0])
    assert (js >= 0).sum() >= 4


@pytest.mark.parametrize("fail", [False, True])
def test_field_and_counts_equal_the_ports_readout(fail):
    from repro_torch.core.desim import simulate_utilization_masked
    from repro_torch.traces.schema import Workload
    week, mask, rows = _case(7, fail=fail)
    t = week["t_bins"]
    w = Workload(*(torch.as_tensor(week[k]) for k in ("submit", "dur", "cores", "util", "valid")))
    kw = {} if rows is None else dict(fail_start=torch.as_tensor(rows[0]).int(),
                                      fail_end=torch.as_tensor(rows[1]).int(),
                                      fail_kill=torch.as_tensor(rows[2]))
    sim = simulate_utilization_masked(w, torch.as_tensor(mask), 8, max_hosts=mask.size,
                                      t_bins=t, policy_id=1, backfill_depth=2, max_backfill=2,
                                      **kw)
    js, jh = sim.job_start.numpy(), sim.job_host.numpy()
    u = readout.field(js, jh, week["dur"], week["cores"], week["util"], num_hosts=mask.size,
                      cores_per_host=8, t_bins=t, fail=rows)
    np.testing.assert_allclose(u, sim.u_th.numpy(), rtol=1e-6, atol=1e-7)
    q, r = readout.queue_and_running(js, jh, week["submit"], week["dur"], week["valid"],
                                     t_bins=t, fail=rows)
    assert np.array_equal(q, sim.queue_len.numpy()) and np.array_equal(r, sim.running.numpy())


def test_the_copied_generator_gives_the_ports_trace_and_telemetry():
    from repro_torch.traces.schema import DatacenterConfig
    from repro_torch.traces.surf import (GroundTruthSpec, SurfTraceSpec, make_surf22_like,
                                         synthesize_ground_truth)
    dc = files.load("configs", "surf-lisa-277")["datacenter"]
    week = surf22.make_week(dict(TRACE, days=1.0), dc, 22)
    port = make_surf22_like(SurfTraceSpec(days=1.0, seed=22), DatacenterConfig(**dc), device="cpu")
    for k, v in (("submit", port.submit_bin), ("dur", port.duration_bins),
                 ("cores", port.cores), ("util", port.util_levels)):
        assert np.array_equal(week[k], v.numpy()), k
    u = np.random.default_rng(3).random((288, dc["num_hosts"])).astype(np.float32)
    gt = files.load("configs", "surf-lisa-277")["ground_truth"]
    np.testing.assert_array_equal(surf22.ground_truth_power(u, gt, 99),
                                  synthesize_ground_truth(u, GroundTruthSpec(**gt, seed=99)))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import twinbench.reference.whatif, twinbench.reference.twin, "
            "twinbench.counts.des_place, twinbench.counts.calib_mape; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=files.CHECKOUT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
