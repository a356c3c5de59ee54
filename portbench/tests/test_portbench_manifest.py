"""BENCHMARK.json and every file it names load, and keep the contract's
form: names, units, paths, and each per-layer metric's cells report the
end-to-end metric it moves."""

import json
import re

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = core.load_json(core.ROOT / "BENCHMARK.json")


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"][1].startswith("portbench/")
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert "setup_s" in names and len(names) == len(set(names))


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    cfg = core.load_json(core.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("entry", MANIFEST["workloads"], ids=lambda e: e["name"])
def test_cells_load(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    cell = core.Cell(entry["name"], MANIFEST)
    cell.generator()
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer()


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_and_moves(metric):
    mod = core.load_module(core.BENCH_DIR / "metrics" / f"{metric['name']}.py", "m")
    assert callable(mod.read)
    moves = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= set(moves.get("workloads", cells))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
