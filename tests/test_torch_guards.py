"""Guards of the port: it imports neither JAX nor the JAX package, nor at
import time the host packages the GPU machine lacks, and its entry points
run on the card unless the caller asks for the CPU."""
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
# research/ is the JAX package's configurations: the port has its own
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "segmentation_pipeline_tpu", "benchmarks",
             "research"}


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


def test_importing_every_port_module_loads_no_optional_host_package():
    """pandas, matplotlib, PIL, cloudpickle and scikit-learn are imported
    only where they are used (CSV attributes, StratifiedFilter, contour
    images, closures in checkpoints), never by importing the port."""
    optional = ["PIL", "cloudpickle", "matplotlib", "pandas", "sklearn"]
    code = (
        "import importlib, pkgutil, sys\n"
        "import segmentation_pipeline_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {optional!r})\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_training_loop_defaults_to_cuda(monkeypatch, tmp_path):
    """A Context with no device puts its network on the card, and the
    ported configurations' predictors run there: without a GPU, both
    raise."""
    from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config
    from segmentation_pipeline_torch.research.msseg2 import msseg2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    context = tsp.Context(name="card")
    context.add_component("model", tsp.NestedResUNet, input_channels=1, output_channels=2,
                          filters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        context.init_components()
    for config in (main_config, msseg2):
        with pytest.raises(RuntimeError, match="CUDA"):
            config.get_context(variables={"DATASET_PATH": str(tmp_path)})
        assert config.get_context(device="cpu", variables={"DATASET_PATH": str(tmp_path)})


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
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.PatchPredict(patch_size=8)
    assert tsp.PatchPredict(patch_size=8, device="cpu").device.type == "cpu"
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


@pytest.mark.parametrize("entry", ["qsm", "augmentation-dwi", "hybrid-host-augment"])
def test_qsm_and_dwi_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    """The qsm configuration, the augmentation config's DWI modes and the
    hybrid cache's host stage run on the card unless asked for the CPU."""
    from segmentation_pipeline_torch.research.dmri_hippo.configs import augmentation
    from segmentation_pipeline_torch.research.qsm_deep_grey_matter import qsm_deep_grey_matter
    from segmentation_pipeline_torch.training.auto_augment import HybridSpec
    from segmentation_pipeline_torch.training.hybrid_augment import HybridHostAugment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    variables = {"DATASET_PATH": str(tmp_path)}
    make = {
        "qsm": lambda **kw: qsm_deep_grey_matter.get_context(
            variables=variables, microbatch=2, tpu_fast_path=True, **kw),
        "augmentation-dwi": lambda **kw: augmentation.get_context(
            variables=variables, augmentation_mode="combined", **kw),
        "hybrid-host-augment": lambda **kw: HybridHostAugment(
            [], HybridSpec([], [], {}, [], None), **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu")


@pytest.mark.parametrize("entry", ["cascade", "cascade-basic-unet", "fused-cleanup-predictor"])
def test_cascade_and_fused_cleanup_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    """The cascade configuration (both model types) and ms_inference's
    fused-cleanup predictor run on the card unless asked for the CPU."""
    from segmentation_pipeline_torch.research.dmri_hippo.configs import cascade
    from segmentation_pipeline_torch.research.msseg2.competition import ms_inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    variables = {"DATASET_PATH": str(tmp_path), "PREDICTIONS_PATH": str(tmp_path)}
    make = {
        "cascade": lambda **kw: cascade.get_context(variables=variables, **kw),
        "cascade-basic-unet": lambda **kw: cascade.get_context(
            variables=variables, model_type="basic_unet", **kw),
        "fused-cleanup-predictor": lambda **kw: ms_inference.competition_predictor(
            device_postprocess=ms_inference.CLEANUP_CHAIN, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu")
