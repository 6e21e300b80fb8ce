"""BENCHMARK.json against the benchmark's contract, and every file that it
names found by name."""

import json
import re

import pytest

from pbfbench import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _metrics():
    return M["end_to_end"] + M["per_layer"]


def test_the_top_level_keys_and_the_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "pbfbench/run.py"]
    assert M["paths"] == ["pbfbench"]
    assert all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(harness.ROOT.joinpath("BENCHMARK.json").read_bytes()) <= 65536


def test_every_name_unit_and_line_uses_the_allowed_characters():
    names = [e["name"] for e in M["configs"] + M["workloads"] + _metrics()]
    names += [w[k] for w in M["workloads"] for k in ("config", "traffic")]
    names += [k for c in M["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in M[group]]
        assert len(seen) == len(set(seen)), group
    all_metrics = [e["name"] for e in _metrics()]
    assert len(all_metrics) == len(set(all_metrics))
    assert all(UNIT.match(e["unit"]) for e in _metrics())
    lines = [c[k] for c in M["configs"] for k in ("why", "source")]
    lines += [w["why"] for w in M["workloads"]]
    lines += [e["layer"] for e in M["per_layer"]]
    assert all(LINE.match(s) for s in lines)


def test_the_entries_have_just_the_contract_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for e in M["end_to_end"]:
        assert set(e) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in M["per_layer"]:
        assert set(e) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(e["better"] in ("lower", "higher") for e in _metrics())
    assert "setup_s" in [e["name"] for e in M["end_to_end"]]
    assert {w["config"] for w in M["workloads"]} == {c["name"] for c in
                                                     M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_share_of_a_roofline_or_a_peak_is_a_percentage():
    for e in _metrics():
        if "_roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_per_layer_metric_moves_a_metric_its_cells_report(cell):
    c = harness.find_cell(cell)
    e2e = [e["name"] for e in harness.metrics_of(c, "end_to_end")]
    layer = harness.metrics_of(c, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for e in layer:
        assert e["moves"] in e2e, (e["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    c = harness.find_cell(cell)
    entry = {e["name"]: e for e in M["configs"]}[c.workload["config"]]
    assert entry["file"].startswith("pbfbench/configs/")
    assert harness.sim_config(c.config).n == c.config["n"]
    assert harness.Traffic.of(c.traffic).calls >= 1
    assert (harness.HERE / "reference" / f"{c.config['reference']}.py").exists()
    for kind in ("end_to_end", "per_layer"):
        for e in harness.metrics_of(c, kind):
            assert callable(harness.reader(e["name"]))
    limits = {k: v for k, v in c.limits.items() if isinstance(v, dict)}
    assert {"x_gap_median", "x_gap", "v_gap_median", "v_gap"} <= set(limits)
    for name, lim in limits.items():
        assert lim["limit"] >= 0, name
        if lim.get("upper"):
            assert lim["lower"] < lim["limit"] < lim["upper"], name


def test_the_configurations_state_their_source_and_cuts():
    for c in M["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["precision"] == "float32"
        assert conf["backend"] == "window"
        assert not any(conf["geometry"][k] for k in
                       ("mxu_sum", "mxu_rd2", "mxu_proj"))


def test_the_files_under_paths_are_named_from_name_characters():
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel
