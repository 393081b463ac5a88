"""Tiny cells of the benchmark's configurations and traffic mixes, for the
CPU tests: the same files, cut to a few hosts, a day or less and a few
lanes and candidates, run on the port's plain kernels."""

from __future__ import annotations

import copy
import types

from twinbench.harness import files


def whatif_cell(seconds_hint: float = 0.5):
    cfg = copy.deepcopy(files.load("configs", "surf-lisa-277"))
    tr = copy.deepcopy(files.load("traffic", "whatif-d64"))
    cfg["datacenter"]["num_hosts"] = 16
    cfg["trace"]["days"] = 0.25
    tr["axes"] = [["power_cap_w", [None, 1900.0]], ["num_hosts", [16, 12]],
                  ["failures", [[], [{"hosts": [0, 4], "start_bin": 30, "end_bin": 50,
                                      "kind": "outage"}]]],
                  ["backfill_depth", [0, 4]],
                  ["policy", ["first_fit", "best_fit", "worst_fit", "random_fit"]]]
    tr["pool_weeks"] = 2
    tr["check"].update(requests=1, lanes_per_request=12)
    return types.SimpleNamespace(name="tiny-whatif", config=cfg, traffic=tr, chips=1)


def replay_cell():
    cfg = copy.deepcopy(files.load("configs", "surf-lisa-277"))
    tr = copy.deepcopy(files.load("traffic", "e2-replay"))
    cfg["datacenter"]["num_hosts"] = 16
    cfg["trace"]["days"] = 1.0
    cfg["calibration"].update(r_points=8, scale_points=3)
    tr["pool_weeks"] = 2
    tr["warmup_weeks"] = 1
    tr["check"]["requests"] = 1
    return types.SimpleNamespace(name="tiny-replay", config=cfg, traffic=tr, chips=1)
