"""What ``BENCHMARK.json`` names, found by name: the manifest, a cell, its
configuration (``configs/<name>.json``), the reference that judges it
(``reference/<name>.py``), its traffic mix (``traffic/<name>.json``) and
the per-layer metric readers (``metrics/<name>.py``).  Adding a cell, a
configuration, a reference, a mix or a metric adds files and entries;
nothing here names one."""

import copy
import importlib.util
import json
import math
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
REFERENCE_DIR = BENCH_DIR / "reference"
# the reference of a configuration whose file names none
DEFAULT_REFERENCE = "plain"
# the numbers that ``reference.compare.numbers`` gives, each with a limit in a
# reference's ``LIMITS``
LIMIT_KEYS = ("loss_gap", "aee_gap", "aee_share", "descent_gain")


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


def _shown(path: Path):
    return path.relative_to(ROOT) if path.is_relative_to(ROOT) else path


def reference(config: dict):
    """The module that judges the configuration's cells:
    ``reference/<name>.py`` for the file's ``"reference"`` (``plain``
    without one), loaded by path (it imports its neighbours as
    ``benchmark.reference.<module>``).  It has to keep the contract that
    ``reference/compare.py`` states; a name with no file, or a module
    without ``reference_answers`` or without a finite limit for each of
    ``LIMIT_KEYS`` (and no other), stops the run."""
    name = config.get("reference", DEFAULT_REFERENCE)
    path = REFERENCE_DIR / f"{name}.py"
    if not (isinstance(name, str) and name.isidentifier() and path.is_file()):
        raise SystemExit(f"benchmark: no reference {_shown(path)} for configuration {config.get('name')!r}")
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    faults = []
    if not callable(getattr(module, "reference_answers", None)):
        faults.append("no reference_answers")
    limits = getattr(module, "LIMITS", None)
    if not isinstance(limits, dict) or set(limits) != set(LIMIT_KEYS):
        faults.append(f"LIMITS must hold exactly {list(LIMIT_KEYS)}")
    elif not all(isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)
                 for v in limits.values()):
        faults.append("a limit in LIMITS is not a finite number")
    if faults:
        raise SystemExit(f"benchmark: reference {_shown(path)} for configuration {config.get('name')!r} "
                         f"breaks its contract: {'; '.join(faults)}")
    return module


def cell_metrics(manifest: dict, workload: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` list, and those that list
    it."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]
