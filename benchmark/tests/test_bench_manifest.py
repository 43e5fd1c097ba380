"""``BENCHMARK.json`` and the files the harness finds by name: every
configuration, workload and per-layer metric file is there and agrees with
its entry, every name and unit keeps to the character rules, and every
per-layer metric's end-to-end target is reported by each of its cells."""

import importlib
import json
import re

import pytest

from benchmark import compare, harness

REPO = harness.REPO
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (REPO / p).is_dir()


def test_run_seconds_fit_the_check_with_every_cell():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    seen = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names)), group
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        seen[group] = names
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configuration_file_found_by_name(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert _line(conf["source"]) and _line(conf["why"])
    assert any(conf["file"].startswith(p + "/") for p in MANIFEST["paths"])
    data = json.loads((REPO / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"] and len(conf["reduced"]) <= 16
    assert all(NAME.match(k) for k in conf["reduced"])
    assert data["source"] == conf["source"]
    assert data["model"]["mode"] in ("image", "video")
    assert any(w["config"] == conf["name"] for w in MANIFEST["workloads"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("name", CELLS)
def test_workload_file_found_by_name(name):
    cell = harness.load_cell(name)
    e = cell.entry
    assert set(e) == {"name", "config", "traffic", "chips", "why"}
    assert e["chips"] in (1, 4) and _line(e["why"])
    for k in ("config", "traffic", "why"):
        assert cell.workload[k] == e[k], k
    assert cell.workload["limits"] and set(cell.workload["limits"]) <= set(compare.READINGS)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert pairs.count((e["config"], e["traffic"])) == 1


def test_four_chip_cells():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", CELLS)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        names = [n for n, m in e2e.items() if _reports(m, cell)]
        assert "setup_s" in names and len(names) >= 2, cell
        assert any(_reports(m, cell) for m in MANIFEST["per_layer"]), cell


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_found_by_name_and_moves_a_reported_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                "host_clock")
    assert _line(metric["layer"])
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS and _reports(e2e[metric["moves"]], cell), cell
    reader = importlib.import_module(f"benchmark.metrics.{metric['name']}")
    assert reader.UNIT == metric["unit"] and callable(reader.read)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    for a in layers:
        for b in layers:
            assert a == b or a.lower() != b.lower()
