"""The benchmark's files: BENCHMARK.json against its contract, every name
found as a file, and a cell, configuration, traffic mix and metric added
by new files alone."""
import json
import re
import shutil

import pytest

from chipbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "chipbench/run.py"]
    assert bench["paths"] == ["chipbench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_entries_have_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("chipbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units(bench):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    names = [e["name"] for g in groups for e in bench[g]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_is_a_file(bench):
    names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in names
        mix = spec.traffic(w["traffic"])
        assert spec.driver(mix["driver"]).run
        assert spec.config(bench, w["config"])["limits"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        ends = {m["name"] for m in spec.metrics_for(bench, w["name"], False)}
        assert "setup_s" in ends and len(ends) >= 2
        layers = spec.metrics_for(bench, w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in ends, (w["name"], m["name"])
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])


def test_a_cell_added_by_files_alone(tmp_path, bench):
    """Copy the harness, add a configuration, a traffic mix and a metric as
    new files and a cell as new entries: spec finds each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    (root / "chipbench/configs/tiny.json").write_text(json.dumps(
        {"name": "tiny", "rows": 10, "limits": {"dist_gap": 1e-5}}))
    (root / "chipbench/traffic/burst.json").write_text(json.dumps(
        {"driver": "hnsw_search", "batch": 1}))
    (root / "chipbench/metrics/calls_per_s.py").write_text(
        "def read(rec):\n    return rec['calls'] / rec['window_s']\n")
    new["configs"].append({"name": "tiny", "source": "https://example.org",
                           "file": "chipbench/configs/tiny.json",
                           "reduced": [], "why": "a test"})
    new["workloads"].append({"name": "tiny.burst", "config": "tiny",
                             "traffic": "burst", "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "calls_per_s", "unit": "calls/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "index / search", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    b = spec.load_benchmark(root)
    w = spec.workload(b, "tiny.burst")
    assert spec.config(b, w["config"], root)["rows"] == 10
    assert spec.traffic(w["traffic"], root / "chipbench")["batch"] == 1
    names = [m["name"] for m in spec.metrics_for(b, "tiny.burst", True)]
    assert names == ["calls_per_s"]
    rd = spec.reader("calls_per_s", root / "chipbench")
    assert rd.read({"calls": 30, "window_s": 2.0}) == 15.0
    assert [m["name"] for m in spec.metrics_for(b, "tiny.burst", False)] \
        == ["setup_s"]
