"""No module the benchmark loads has the top-level name of JAX, its
libraries or the JAX package, and the plain references import nothing of
the program."""
import ast
import subprocess
import sys
from pathlib import Path

from h100_bench import harness

BENCH = Path(harness.BENCH)


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    for path in BENCH.rglob("*.py"):
        for name in imported(path):
            assert name.split(".", 1)[0] not in harness.FORBIDDEN_MODULES, (path, name)
            assert not name.startswith(("benchmarks", "bench", "chip_smoke")), (path, name)
    for path in (BENCH / "reference").glob("*.py"):
        for name in imported(path):
            assert name.split(".", 1)[0] != "segmentation_pipeline_torch", (path, name)


def test_top_level_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    monkeypatch.setitem(sys.modules, "segmentation_pipeline_tpu_notes", sys)
    before = harness.forbidden_modules()
    assert "jaxlike" not in before and "segmentation_pipeline_tpu_notes" not in before
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in harness.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from h100_bench import harness, run, calibrate;"
            "from h100_bench.tests.small import SMALL;"
            "spec = harness.load_spec();"
            "r = harness.run_cell(spec, 'hippo-tta-bf16', 3, 0.5, True, time.time(), "
            "device='cpu', overrides=SMALL['hippo-tta-bf16']);"
            "[harness.load_metric(m['name']) for m in spec['per_layer']];"
            "print('FORBIDDEN', harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
