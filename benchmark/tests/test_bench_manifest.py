"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds and the time budget, and that every cell's files are found."""

import json
import re

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return cells.load_manifest()


def one_line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == TOP_KEYS
    assert len(cells.MANIFEST.read_bytes()) <= 64 * 1024
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (cells.ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:  # a file the command names lies under paths
            assert any(word.startswith(p.rstrip("/") + "/") for p in manifest["paths"]), word
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_time_budget_fits_24_cells(manifest):
    run = manifest["run_seconds"]
    cells_max = 24
    total = (2 + 14 * cells_max) * (run + 60) + cells_max * 2 * 90 + 1200
    assert total <= 43200


def test_entries(manifest):
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (cells.ROOT / c["file"]).is_file()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for kind, entries in (("configs", manifest["configs"]), ("workloads", manifest["workloads"]),
                          ("metrics", manifest["end_to_end"] + manifest["per_layer"])):
        for e in entries:
            assert NAME.match(e["name"]), e["name"]
        assert len({e["name"] for e in entries}) == len(entries), kind
        names |= {e["name"] for e in entries}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(manifest["workloads"]) // 4)


def test_end_to_end(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    workloads = {w["name"] for w in manifest["workloads"]}
    for w in workloads:
        reported = {m["name"] for m in cells.cell_metrics(manifest, w, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert cells.cell_metrics(manifest, w, "per_layer")


def test_per_layer(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    workloads = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m.get("workloads", []):
            assert w in workloads
            assert m["moves"] in {e["name"] for e in cells.cell_metrics(manifest, w, "end_to_end")}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_is_found(manifest):
    for w in manifest["workloads"]:
        config = cells.load_json("configs", w["config"])
        traffic = cells.load_json("traffic", w["traffic"])
        assert config["name"] == w["config"] and traffic["name"] == w["traffic"]
        run = cells.port_config(config, traffic)
        assert run["solver"]["seed"] == config["port"]["solver"]["seed"]
        for path, value in traffic["port"].items():
            section, key = path.split(".")
            assert run[section][key] == value
        listed = next(c for c in manifest["configs"] if c["name"] == w["config"])
        assert listed["reduced"] == config["reduced"]
        reference = cells.reference(config)  # stops the run if it breaks its contract
        assert callable(reference.reference_answers) and set(reference.LIMITS) == set(cells.LIMIT_KEYS)
    for m in manifest["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))


def test_config_files_name_their_keys(manifest):
    for c in manifest["configs"]:
        config = json.loads((cells.ROOT / c["file"]).read_text())
        assert {"source", "reduced", "assumed", "scene", "port"} <= set(config)
        assert config["source"] == c["source"]
