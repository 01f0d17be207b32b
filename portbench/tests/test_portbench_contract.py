"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it finds its piece under ``portbench/``."""

import importlib
import json
import re

import pytest

from portbench import faults, spec

BENCH_PATH = spec.ROOT / "BENCHMARK.json"
BENCH = spec.load_json(BENCH_PATH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}
REFERENCE_CONTROLS = ("reference_bf16", "reference_tf32")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH_PATH.stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
    run_seconds = BENCH["run_seconds"]
    assert isinstance(run_seconds, int) and 1 <= run_seconds <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (run_seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_have_plain_names():
    for p in BENCH["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                assert PATH.match(str(f.relative_to(spec.ROOT))), f


def test_names_and_units():
    names = {"configs": [], "workloads": [], "metrics": []}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names["configs"].append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names["workloads"].append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names["metrics"].append(m["name"])
    for group in names.values():
        assert len(group) == len(set(group))
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_end_to_end_metrics():
    assert 1 <= len(E2E) <= 16 and "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_per_layer_metrics():
    assert 1 <= len(BENCH["per_layer"]) <= 128
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in E2E[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 4


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    c = spec.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert c.chips == 1


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_name_finds_its_piece(cell):
    c = spec.load_cell(cell)
    importlib.import_module(f"portbench.problems.{c.config['family']}")
    importlib.import_module(f"portbench.kinds.{c.traffic['kind']}")
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for key in ("source", "scaled", "assumed", "dtype", "solve", "check"):
        assert key in c.config
    # the upstream notebooks' 1e-3, or tighter where the check needs it
    assert 0 < c.config["solve"]["rel_tol"] <= 1e-3
    for control in c.config["check"]["controls"]:
        assert control["mode"] in faults.CONTROLS or control["mode"] in REFERENCE_CONTROLS
    assert set(c.config["check"]["limits"]) == set(c.config["check"]["numbers"])


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        # every key changed from the source is named in reduced: a size
        # scaled, or a departure from the source's formulation
        assert set(data["scaled"]) | set(data.get("departures", {})) == set(c["reduced"])
        assert all(w["config"] in {c["name"] for c in BENCH["configs"]} for w in BENCH["workloads"])
