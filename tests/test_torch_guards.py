"""Guards of the port: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.prediction import StandardPredict

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "segmentation_pipeline_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "segmentation_pipeline_tpu", "benchmarks"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import segmentation_pipeline_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_default_to_cuda(monkeypatch):
    """No silent CPU fallback: without a GPU and without device='cpu', the
    entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    subject = tsp.Subject(name="s")
    subject["X"] = tsp.ScalarImage(tensor=np.zeros((1, 2, 2, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.SegModel(tsp.NestedResUNet(1, 2, filters=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.collate_subjects([subject], ["X"])
    with pytest.raises(RuntimeError, match="CUDA"):
        StandardPredict()
    assert tsp.collate_subjects([subject], ["X"], device="cpu")["X"].device.type == "cpu"
    batch = {"X": np.zeros((1, 1, 2, 2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.collate_to_device(batch)
    assert tsp.collate_to_device(batch, device="cpu")["X"].device.type == "cpu"
    model = tsp.SegModel(tsp.NestedResUNet(1, 2, filters=2), device="cpu")
    state = tsp.create_train_state(model, tsp.Adam(), batch)
    assert all(p.device.type == "cpu" for p in state.params.values())
    # a model placed on the card (made, or unpickled, where one was)
    model.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.create_train_state(model, tsp.Adam(), batch)
