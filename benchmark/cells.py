"""What ``BENCHMARK.json`` names, found by name: the manifest, a cell, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``) and the per-layer metric readers
(``metrics/<name>.py``).  Adding a cell, a configuration, a mix or a
metric adds files and entries; nothing here names one."""

import copy
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"benchmark: {path.relative_to(ROOT)} is missing")
    with open(path) as f:
        return json.load(f)


def port_config(config: dict, traffic: dict) -> dict:
    """The port's config dict (its YAML schema) of one cell: the
    configuration's ``port`` blocks with the traffic mix's ``port``
    overrides (``SECTION.KEY`` -> value).  The solver's own seed is the
    configuration's, so every run's cold draws and sweeps are the same;
    the run's seed draws the scene's events."""
    run = copy.deepcopy(config["port"])
    for path, value in traffic.get("port", {}).items():
        section, key = path.split(".", 1)
        run[section][key] = copy.deepcopy(value)
    return run


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"benchmark: no reader {path.relative_to(ROOT)} for metric {name!r}")
    # loaded by path: a metric's name may hold '.' or '-'
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(name)}_{abs(hash(name))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(manifest: dict, workload: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` list, and those that list
    it."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]
