"""A configuration names the reference that judges its cells
(``"reference"`` in its file, ``plain`` without one), found by path
(``cells.reference``) before set-up.  The shipped configurations resolve
to ``plain``; a stub reference judges a run by its own answers and limits;
a name with no file, or a module that breaks the contract, stops the run
before set-up; and a configuration with a reference of its own joins as
new files and manifest entries alone."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import cells, harness
from benchmark.reference import compare, plain
from benchmark.scene import Sequence
from benchmark.tests.conftest import tiny_cell

STUB_LIMITS = {"loss_gap": 0.0, "aee_gap": 0.25, "aee_share": 0.6, "descent_gain": 0.0}
ANSWERS = '''

def reference_answers(answers, stream, scene, config, device, tf32=False):
    # the program's loss; an AEE 1.25 times the program's, and zero flow's twice that
    return [(a.loss, 1.25 * a.aee, 2.5 * a.aee, 0.0) for a in answers]
'''
# what the stub's answers read against the program's: aee_gap 0.25 / 1.25
STUB_READS = {"loss_gap": 0.0, "aee_gap": 0.2, "aee_share": 0.5, "descent_gain": 0.0}
BROKEN = {
    "no_answers": f"LIMITS = {STUB_LIMITS!r}\n",
    "no_limits": ANSWERS,
    "three_limits": "LIMITS = {'loss_gap': 1.0, 'aee_gap': 1.0, 'aee_share': 1.0}\n" + ANSWERS,
    "five_limits": f"LIMITS = {dict(STUB_LIMITS, frames=1.0)!r}\n" + ANSWERS,
    "nan_limit": f"LIMITS = {STUB_LIMITS!r}\nLIMITS['aee_gap'] = float('nan')\n" + ANSWERS,
}
SEED = 2**31 + 21


def stub(limits: dict) -> str:
    return f"LIMITS = {limits!r}\n" + ANSWERS


def argv(workload: str) -> list:
    return ["--workload", workload, "--seed", str(SEED), "--seconds", "0", "--trace", "0"]


def no_set_up(*args, **kwargs):
    raise AssertionError("set-up ran")


@pytest.mark.parametrize("workload", ["mvsec-fleet-b8", "dsec-seq"])
def test_shipped_configurations_resolve_to_plain(workload):
    entry = cells.find(cells.load_manifest()["workloads"], workload, "workload")
    assert "reference" not in cells.load_json("configs", entry["config"])
    config, traffic = tiny_cell(workload)
    reference = cells.reference(config)
    assert reference.__file__ == plain.__file__
    run = cells.port_config(config, traffic)
    seq = Sequence(config["scene"], SEED, 6)
    grid = plain.finest_geometry(run["solver"], (seq.height, seq.width))["grid"]
    rng = np.random.default_rng(0)
    dt = int(run["data"]["eval_dt"])
    answers = [compare.Answer(t1=seq.gray_ts[k], t2=seq.gray_ts[k + dt],
                              motion=torch.as_tensor(rng.normal(scale=10.0, size=(2, *grid))), loss=0.0, aee=0.0)
               for k in range(2)]
    got = reference.reference_answers(answers, seq.events, seq, run, "cpu")
    assert got == plain.reference_answers(answers, seq.events, seq, run, "cpu")
    assert got == compare.reference_answers(answers, seq.events, seq, run, "cpu")


@pytest.fixture(scope="module")
def measured():
    """One tiny ``dsec-seq`` window on the CPU (a frame), measured once."""
    config, traffic = tiny_cell("dsec-seq")
    torch.manual_seed(0)
    return harness.measure(config, traffic, SEED, torch.device("cpu"), 0.0, False, time.perf_counter())


@pytest.mark.parametrize("aee_gap", [0.25, 0.15])
def test_a_stub_reference_judges_the_run(aee_gap, measured, tmp_path, monkeypatch, capsys):
    """The stub's answers and its limits decide: with an ``aee_gap`` limit
    above its reading of 0.2 the run is correct (the plain limit, 2e-6,
    would fail it), below it every frame fails."""
    limits = dict(STUB_LIMITS, aee_gap=aee_gap)
    (tmp_path / "stub_reference.py").write_text(stub(limits))
    monkeypatch.setattr(cells, "REFERENCE_DIR", tmp_path)
    monkeypatch.setattr(harness, "measure", lambda *args: measured)
    config, traffic = tiny_cell("dsec-seq")
    config["reference"] = "stub_reference"
    rc = harness.main(argv("dsec-seq"), device="cpu", require_cuda=False, cell=(config, traffic))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    checks = result["checks"]
    assert {k: checks[k]["limit"] for k in cells.LIMIT_KEYS} == limits
    assert {k: checks[k]["value"] for k in cells.LIMIT_KEYS} == pytest.approx(STUB_READS, abs=1e-12)
    correct = aee_gap > STUB_READS["aee_gap"]
    assert result["correct"] is correct
    assert result["failed"] == (0 if correct else result["attempted"]) and result["attempted"] >= 1
    assert f"check aee_gap: 0.2 (limit {aee_gap:g})" in out.err


@pytest.mark.parametrize("name", ["no_such_module", "../reference/plain"])
def test_an_unknown_reference_stops_the_run_before_set_up(name, monkeypatch):
    monkeypatch.setattr(harness, "measure", no_set_up)
    monkeypatch.setattr(harness, "Driver", no_set_up)
    config, traffic = tiny_cell("mvsec-fleet-b8")
    config["reference"] = name
    with pytest.raises(SystemExit) as stop:
        harness.main(argv("mvsec-fleet-b8"), device="cpu", require_cuda=False, cell=(config, traffic))
    assert f"benchmark/reference/{name}.py" in str(stop.value.code)


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_a_reference_that_breaks_the_contract_stops_the_run(fault, tmp_path, monkeypatch):
    path = tmp_path / f"{fault}.py"
    path.write_text(BROKEN[fault])
    monkeypatch.setattr(cells, "REFERENCE_DIR", tmp_path)
    monkeypatch.setattr(harness, "measure", no_set_up)
    monkeypatch.setattr(harness, "Driver", no_set_up)
    config, traffic = tiny_cell("dsec-seq")
    config["reference"] = fault
    with pytest.raises(SystemExit) as stop:
        harness.main(argv("dsec-seq"), device="cpu", require_cuda=False, cell=(config, traffic))
    assert str(path) in str(stop.value.code) and "breaks its contract" in str(stop.value.code)


def test_a_configuration_with_its_own_reference_joins_as_files(tmp_path):
    """A checkout of the benchmark with new files and new BENCHMARK.json
    entries only: a reference module, two configurations that name it or
    a missing one, and their cells.  ``run.py`` stops the second before
    set-up and before its look for a card, naming the missing file; the
    first runs (tiny, on the CPU) and is judged by the stub."""
    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "reference" / "stub_reference.py").write_text(stub(STUB_LIMITS))
    manifest = cells.load_manifest()
    config, _ = tiny_cell("dsec-seq")
    for name, reference in (("tiny-stub", "stub_reference"), ("tiny-missing", "no_such_module")):
        file = f"benchmark/configs/{name}.json"
        (tmp_path / file).write_text(json.dumps(dict(config, name=name, reference=reference)))
        manifest["configs"].append({"name": name, "source": "a stub", "file": file, "reduced": [],
                                    "why": "a reference of its own"})
        manifest["workloads"].append({"name": f"{name}-seq", "config": name, "traffic": "seq", "chips": 1,
                                      "why": "a reference of its own"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}

    proc = subprocess.run([sys.executable, "benchmark/run.py", *argv("tiny-missing-seq")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "benchmark/reference/no_such_module.py" in proc.stderr and "CUDA device" not in proc.stderr

    code = (f"import sys; sys.path[0] = '.'; sys.path.append({str(cells.ROOT)!r}); from benchmark import harness; "
            f"sys.exit(harness.main({argv('tiny-stub-seq')!r}, device='cpu', require_cuda=False))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert {k: result["checks"][k]["limit"] for k in cells.LIMIT_KEYS} == STUB_LIMITS
    assert {k: result["checks"][k]["value"] for k in cells.LIMIT_KEYS} == pytest.approx(STUB_READS, abs=1e-12)
