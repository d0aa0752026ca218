"""Nothing a benchmark run loads is JAX, the JAX package or its benchmarks,
compared by whole top-level module names."""
import subprocess
import sys

from bench import harness

PROGRAM = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import bench.run, bench.control, bench.clients.session, bench.reference.star
from bench import harness
for metric in (harness.BENCH / "metrics").glob("*.py"):
    harness.reader(metric.stem)
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
print("forbidden:" + ",".join(harness.forbidden_loaded()))
"""


def test_the_import_graph_holds_no_jax():
    code = PROGRAM.format(src=str(harness.ROOT / "src"),
                          root=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{root!r}];"
            "import bench.reference.star, bench.check, bench.data.tpch, "
            "bench.roofline, bench.loadgen;"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro', 'repro_torch', 'jax')))"
            ).format(root=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
