"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.benchmark()


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_names_units_and_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for key in ("end_to_end", "per_layer"):
        for m in b[key]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in b[k]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_files_found_by_name():
    b = bench()
    for w in b["workloads"]:
        c = spec.cell(w["name"], b)
        assert c.config["name"] == w["config"]
        assert c.traffic["clients"] >= 1
        assert {m.name for m in c.end_to_end} >= {"card_ms_per_ktok",
                                                   "setup_s"}
        assert c.per_layer, w["name"]
        spec.model_fields(c.config)
    for key in ("end_to_end", "per_layer"):
        for m in b[key]:
            assert callable(spec.reader(m["name"]))


def test_per_layer_moves_a_metric_its_cells_report():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_configs_are_whole():
    """Every cell runs its model at the published size: nothing reduced."""
    for c in bench()["configs"]:
        assert c["reduced"] == []
        cfg = spec.config(c["name"])
        assert cfg["source"] == c["source"]
