"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json

import pytest

from twinbench.harness import files

SPEC = files.manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in SPEC["workloads"]]
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "twinbench/run.py"]
    assert SPEC["paths"] == ["twinbench"]
    assert (files.CHECKOUT / SPEC["command"][1]).is_file()
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    r = SPEC["run_seconds"]
    assert 1 <= r <= 51 and isinstance(r, int)
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"]] + PER_LAYER
             + [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for n in names:
        assert files.NAME.fullmatch(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert files.UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got)), group


def test_entries_have_just_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("twinbench/configs/")
        for k in ("why", "source"):
            assert 1 <= len(c[k]) <= 200 and "\n" not in c[k] and "\t" not in c[k]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree_with_the_manifest(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = files.Cell(cell)
    assert (c.config_name, c.traffic_name, c.chips, c.why) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    conf = next(x for x in SPEC["configs"] if x["name"] == c.config_name)
    assert json.loads((files.CHECKOUT / conf["file"]).read_text()) == c.config
    assert c.config["source"] == conf["source"] and c.config["reduced"] == conf["reduced"]
    assert files.driver(c.traffic["driver"]).run
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", [cell]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_metric_files_agree_and_moves_a_reported_metric(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert files.load("metrics", name) == entry
    assert callable(files.metric_reader(name))
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:
        assert cell in CELLS and cell in moved.get("workloads", [cell])


def test_every_config_is_used_and_every_file_is_named():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for kind, names in (("configs", used), ("workloads", set(CELLS)),
                        ("traffic", {w["traffic"] for w in SPEC["workloads"]})):
        on_disk = {p.stem for p in (files.ROOT / kind).glob("*.json")}
        assert on_disk == names, kind


@pytest.mark.parametrize("cell", CELLS)
def test_every_compared_number_has_a_limit(cell):
    limits = files.Cell(cell).traffic["check"]["limits"]
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def test_names_are_refused_outside_the_alphabet():
    for bad in ("a b", "a/b", "", "-x", "é"):
        with pytest.raises(ValueError):
            files.check_name(bad)
