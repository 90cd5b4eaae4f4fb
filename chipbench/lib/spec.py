"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``chipbench/traffic/<name>.json``),
the driver the mix names (``chipbench/drivers/<driver>.py``) and the
reader of each metric (``chipbench/metrics/<name>.py``, a module with a
``read(record)`` that returns a number or None). A new cell, mix,
configuration or metric is new files and new entries: nothing here
changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "chipbench"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"chipbench.drivers.{name}")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones; a metric without ``workloads`` is
    every cell's."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, here: Path = HERE):
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
