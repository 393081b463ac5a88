"""The DES roofline of the port (``analysis/roofline_torch.py``) against
the JAX script (``analysis/roofline.py``): the same keys and the same
workload at a quarter day; the port's phase counts repeat exactly, and
``des_place`` is one op charged by its formula.  JAX's XLA counts are
recorded beside the port's (``-s``), not equated: XLA counts every
elementwise op as FLOPs and sees a fused program.
"""

import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import cost  # noqa: E402
from repro_torch.core import desim  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig, host_mask  # noqa: E402
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DAYS = 0.25


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "analysis" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("roofline_torch")


def test_keys_and_workload_match_the_jax_script(port):
    jax_mod = _load("roofline")
    want = jax_mod.analyze_des_hot_path(DAYS)
    got = port.analyze_des_hot_path(DAYS, device="cpu")
    assert set(got) == set(want)
    for k in ("days", "t_bins", "num_hosts", "jobs", "cost_analysis_available"):
        assert got[k] == want[k], k
    assert [p["name"] for p in got["phases"]] == [p["name"] for p in want["phases"]]
    for g, w in zip(got["phases"], want["phases"]):
        assert set(g) == set(w) | {"bound_s"}
        assert g["wall_s"] > 0 and g["bound_s"] > 0
        print(f"{g['name']}: port FLOPs {g['flops']:.6g} bytes {g['bytes']:.6g}; "
              f"XLA FLOPs {w['flops']} bytes {w['bytes']}")
    place, read, total = got["phases"]
    assert place["flops"] > 0 and read["bytes"] > place["bytes"]
    assert total["flops"] == place["flops"] + read["flops"]
    assert total["bytes"] == place["bytes"] + read["bytes"]
    print(port.table(got))


def test_phase_counts_repeat_on_the_cpu(port):
    a = port.phase_costs(DAYS, device="cpu")
    b = port.phase_costs(DAYS, device="cpu")
    assert a == b


def test_des_place_is_one_op_charged_by_its_formula():
    dc = DatacenterConfig()
    t_bins = int(DAYS * BINS_PER_DAY)
    w = make_surf22_like(SurfTraceSpec(days=DAYS), dc, device="cpu")
    mask = host_mask(dc.num_hosts, dc.num_hosts)
    placed = desim._place_masked(w, mask, dc.cores_per_host, max_hosts=dc.num_hosts,
                                 t_bins=t_bins, max_starts_per_bin=64, policy_id=None,
                                 backfill_depth=0, max_backfill=0)
    wl, _, _, cph, _, _ = placed
    s, j = wl.submit_bin.shape
    args = (wl.submit_bin, wl.duration_bins, wl.cores, wl.valid, mask.expand(s, -1).contiguous(),
            cph, torch.full((s,), desim.WORST_FIT, dtype=torch.int32),
            torch.zeros(s, dtype=torch.int32))
    out = cost.trace_cost(lambda *a: ops.des_place(*a, t_bins=t_bins), *args)
    start, host, attempts = out["out"]
    assert out["num_ops"] == 1
    assert out["flops_per_device"] == ops.des_place_ops(int(attempts.sum()), s, t_bins,
                                                        dc.num_hosts)
    assert out["flops_per_device"] == (int(attempts.sum()) + s * t_bins) * dc.num_hosts
    nbytes = sum(t.numel() * t.element_size() for t in (*args, start, host, attempts))
    assert out["bytes_per_device"] == nbytes
    assert torch.equal(start, placed[1]) and torch.equal(host, placed[2])
