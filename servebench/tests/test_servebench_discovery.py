"""Cells, configurations, mixes and per-layer metrics are found by
name, and a new one is added by new files alone."""
import json
import re
import shutil

import pytest

from servebench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_of_the_benchmark_loads():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.rate > 0
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.chips == w["chips"] == 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))


def test_benchmark_json_keeps_to_its_form():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["servebench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    e2e = [m["name"] for m in bench["end_to_end"]]
    layer = [m["name"] for m in bench["per_layer"]]
    for n in names + cells + e2e + layer:
        assert NAME.match(n), n
    for group in (names, cells, e2e + layer):
        assert len(group) == len(set(group))
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert c["file"] == f"servebench/configs/{c['name']}.json"
        assert json.loads((spec.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # read only in cells that report the metric it moves
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]
    for w in cells:
        assert any(w in r for n, r in reports.items() if n != "setup_s")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_config_mix_and_metric_are_new_files_alone(tmp_path):
    base = tmp_path / "servebench"
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs/phi3-mini-3.8b.json").read_text())
    cfg["name"] = "phi3-copy"
    (base / "configs/phi3-copy.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic/docqa.json").read_text())
    mix.update(name="burst", clients=4)
    (base / "traffic/burst.json").write_text(json.dumps(mix))
    (base / "cells/phi3-copy.burst.json").write_text(json.dumps(
        {"config": "phi3-copy", "traffic": "burst", "rate": 1.5,
         "check": {"tokens": 100, "max_logit_gap": 1.0}}))
    (base / "metrics/served_count.py").write_text(
        "def read(record):\n    return len(record.served) or None\n")
    bench = spec.benchmark()
    bench["workloads"].append({"name": "phi3-copy.burst",
                               "config": "phi3-copy", "traffic": "burst",
                               "chips": 1})
    bench["per_layer"].append({"name": "served_count", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine scheduler",
                               "moves": "tpot_ms",
                               "workloads": ["phi3-copy.burst"]})
    cell = spec.load_cell("phi3-copy.burst", bench=bench, base=base)
    assert cell.rate == 1.5 and cell.traffic["clients"] == 4
    assert [m["name"] for m in cell.per_layer][-1] == "served_count"
    old = spec.load_cell("phi3-mini-3.8b.docqa", bench=bench, base=base)
    assert "served_count" not in [m["name"] for m in old.per_layer]

    class Rec:
        served = {1: None, 2: None}
    assert spec.metric_reader("served_count", base=base)(Rec()) == 2
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_cell_must_name_what_the_benchmark_names(tmp_path):
    base = tmp_path / "servebench"
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "cells/phi3-mini-3.8b.docqa.json").write_text(json.dumps(
        {"config": "phi3-mini-3.8b", "traffic": "longchat", "rate": 1,
         "check": {}}))
    with pytest.raises(ValueError):
        spec.load_cell("phi3-mini-3.8b.docqa", base=base)
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", base=base)
