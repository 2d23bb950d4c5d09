"""Discovery by file name, and ``BENCHMARK.json`` against the contract it
is written to: every cell, configuration, mix, loop and metric is a file
of its own that the harness finds by the name ``BENCHMARK.json`` gives."""
import json
import re

import pytest

from portbench import harness
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def cells(bench):
    return [w["name"] for w in bench["workloads"]]


def metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_names_units_and_lines():
    bench = BENCH
    for entry in bench["configs"] + bench["workloads"] + metrics(bench):
        assert NAME.match(entry["name"]), entry["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] == 1
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in metrics(bench):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for c in bench["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    names = [e["name"] for e in bench["configs"] + bench["workloads"]
             + metrics(bench)]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = BENCH
    for cell in cells(bench):
        found = harness.find_cell(cell, bench).metrics
        kinds = [m["kind"] for m in found]
        assert "setup_s" in [m["name"] for m in found]
        assert kinds.count("end_to_end") >= 2 and "per_layer" in kinds


def test_per_layer_metrics_move_what_their_cells_report():
    bench = BENCH
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells(bench))


@pytest.mark.parametrize("metric", metrics(BENCH),
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_declares_it(metric):
    mod = harness.find_module("metrics", metric["name"])
    assert callable(mod.read)
    assert mod.UNIT == metric["unit"] and mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert mod.LAYER == metric["layer"]


@pytest.mark.parametrize("cell", cells(BENCH))
def test_every_cell_finds_its_files(cell):
    bench = BENCH
    c = harness.find_cell(cell, bench)
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    assert callable(c.loop().window) and callable(c.loop().judge)
    assert c.limits and all(v >= 0 for v in c.limits.values())


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_configs_are_files_of_their_own(config):
    path = harness.ROOT / config["file"]
    assert path.parent == harness.BENCH / "configs"
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"] == []
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_a_quantity_reader_serves_every_metric_of_it():
    assert harness.find_module("metrics", "device_idle.anything").read \
        is harness.find_module("metrics", "device_idle").read
    with pytest.raises(FileNotFoundError):
        harness.find_module("metrics", "no_such_metric")


def test_a_cell_missing_from_the_benchmark_is_not_found():
    with pytest.raises(KeyError):
        harness.find_cell("nf-u16.live")


def test_every_file_is_named_from_name_characters():
    for path in harness.BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = str(path.relative_to(harness.ROOT))
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200
