"""``run.py`` as the driver starts it: no result without a card, none in a
directory that holds only the benchmark, and nothing of JAX or the JAX
package loaded (nothing of the port either, in the reference)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "event_based_optical_flow_tpu"}
PORT = "event_based_optical_flow_tpu_torch"


def _run(cwd, *args, env=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})}
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    proc = _run(cells.ROOT, "--workload", "dsec-seq", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_alone_fails(tmp_path):
    """Past the look for a card, a checkout of BENCHMARK.json and
    ``benchmark/`` alone has no program to run: no result."""
    shutil.copy(cells.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[0] = '.'; from benchmark import harness; "
            "sys.exit(harness.main(['--workload', 'mvsec-fleet-b8', '--seed', '1', '--seconds', '1', "
            "'--trace', '0'], device='cpu', require_cuda=False))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "event_based_optical_flow_tpu_torch" in proc.stderr


def _top_level_after(code: str) -> set:
    probe = (f"import sys; sys.path.insert(0, {str(cells.ROOT)!r}); {code}; import json; "
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=600,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    """The reference modules as the harness loads them: each configuration's
    through ``cells.reference``, and the comparison."""
    names = _top_level_after("import benchmark.reference.compare, benchmark.scene; from benchmark import cells; "
                             "[cells.reference(cells.load_json('configs', c['name'])) "
                             "for c in cells.load_manifest()['configs']]")
    assert not names & FORBIDDEN
    assert PORT not in names


@pytest.mark.parametrize("workload", ["mvsec-fleet-b8", "dsec-seq"])
def test_a_whole_run_loads_no_jax(workload):
    """A tiny run of the cell on the CPU, from ``run.py``'s module down
    (``harness.main``), then the process's top-level module names."""
    code = ("import io, contextlib, benchmark.run, benchmark.tests.conftest as c; from benchmark import harness; "
            f"out = io.StringIO(); cell = c.tiny_cell({workload!r});\n"
            "with contextlib.redirect_stdout(out):\n"
            f"    rc = harness.main(['--workload', {workload!r}, '--seed', '7', '--seconds', '0', '--trace', '0'], "
            "device='cpu', require_cuda=False, cell=cell)\n"
            "assert rc == 0 and json.loads(out.getvalue().splitlines()[-1])['correct']")
    names = _top_level_after("import json\n" + code)
    assert PORT in names
    assert not names & FORBIDDEN, names & FORBIDDEN
