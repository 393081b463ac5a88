"""The benchmark's files, found by name.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a cell ``workloads/<name>.json``, a driver
``drivers/<name>.py`` and a per-layer metric ``metrics/<name>.json`` with its
reader ``metrics/<name>.py``.  ``BENCHMARK.json`` at the checkout's root lists
the cells and the metrics.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
#: the folders whose JSON files are looked up by name
KINDS = ("configs", "traffic", "workloads", "metrics")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` as a dict."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    path = ROOT / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def manifest() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def driver(name: str):
    """The module ``drivers/<name>.py``."""
    return importlib.import_module(f"twinbench.drivers.{check_name(name)}")


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py`` (a name may hold dots, so the file
    is loaded by its path)."""
    path = ROOT / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "twinbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """One entry of ``workloads``: its configuration and traffic mix, read
    from their files."""

    def __init__(self, name: str):
        self.name = check_name(name)
        spec = load("workloads", name)
        self.config_name = spec["config"]
        self.traffic_name = spec["traffic"]
        self.chips = int(spec["chips"])
        self.why = spec["why"]
        self.config = load("configs", self.config_name)
        self.traffic = load("traffic", self.traffic_name)
