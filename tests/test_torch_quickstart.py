"""``examples/api_quickstart_torch.py``, the port's library-API quickstart,
runs on the CPU (``--device cpu``, the kernels' plain versions) and prints
one line per window with a finite mean flow."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_quickstart_prints_one_finite_line_per_window():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "api_quickstart_torch.py"), "--device", "cpu",
                          "--windows", "1"], capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    m = re.fullmatch(r"window 0: mean flow \(([-+]\d+\.\d), ([-+]\d+\.\d)\) px  vs GT \(\+6\.0, -4\.0\)", lines[0])
    assert m, lines[0]
    u, v = float(m.group(1)), float(m.group(2))
    assert abs(u - 6.0) < 1.0 and abs(v + 4.0) < 1.0, lines[0]
