"""The port's public surface against the JAX package's, on the CPU: the
facade's names (less what waits for spatial sharding and the XLA
compilation cache), the sweep script's lines, the helpers of utils/misc.py,
typing.PathLike, TorchContext and Context.remove_components, the dataset
fingerprint (with and without a transform, and its saved JSON), and
ProfilerTrace's trace file."""
import io
import json
import types
from contextlib import redirect_stdout

import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo import generate_parallel_commands as jcommands
from segmentation_pipeline_tpu.utils import misc as jmisc
from segmentation_pipeline_torch.research.dmri_hippo import generate_parallel_commands as tcommands
from segmentation_pipeline_torch.utils import misc as tmisc
from segmentation_pipeline_torch.utils.timer import ProfilerTrace
from test_torch_trainer import build_dataset

# ROADMAP Queue 1 item 10b (spatial sharding), and the XLA compilation
# cache, which has no counterpart on the card
JAX_ONLY = {"make_spatial_train_step", "enable_compilation_cache",
            "enable_compilation_cache_from_env"}
# the port's own: its optimizer wrapper and the flax weight bridge
PORT_ONLY = {"MultiSteps", "flax_to_state_dict", "state_dict_to_flax", "device"}


def _public(module):
    """Public names, less the submodules a star import of transforms drags
    in; the modules the facade imports by name stay."""
    named_modules = {"native", "ops", "post_processing", "parallel", "device"}
    return {n for n in dir(module) if not n.startswith("_")
            and (not isinstance(getattr(module, n), types.ModuleType) or n in named_modules)}


def test_facade_names_match_jax():
    assert _public(tsp) - PORT_ONLY == _public(jsp) - JAX_ONLY
    for name in ("native", "ops", "parallel"):
        assert getattr(tsp, name).__name__ == f"segmentation_pipeline_torch.{name}"
    assert tsp.TorchContext is tsp.Context and tsp.PathLike == jsp.PathLike


def test_generate_parallel_commands_print_the_ports_module(tmp_path):
    for task_count, task_id, cpus in ((1, 0, 4), (4, 1, 8), (32, 31, 2)):
        lines = []
        for module, folder in ((jcommands, "jax"), (tcommands, "port")):
            out = io.StringIO()
            with redirect_stdout(out):
                module.main(task_count, task_id, cpus, str(tmp_path / folder))
            lines.append(out.getvalue().replace(str(tmp_path / folder), "TMP").splitlines())
        jax, port = lines
        assert port == [line.replace("python -m research.dmri_hippo.run",
                                     "python -m segmentation_pipeline_torch.research."
                                     "dmri_hippo.run") for line in jax]
        assert len(port) == len(range(task_id, 20, task_count))


def test_misc_helpers_match_jax():
    nested = {"a": {"b": 1, "c": {"d": [2]}}, "e": 3}
    for sep in (".", "/"):
        assert tmisc.flatten_nested_dict(nested, sep=sep) == \
            jmisc.flatten_nested_dict(nested, sep=sep)
    assert tmisc.flatten_nested_dict(nested, "p") == jmisc.flatten_nested_dict(nested, "p")
    batch = [object()]
    assert tmisc.no_op(batch) is batch and jmisc.no_op(batch) is batch

    def fixed(a, b=1):
        return a

    def open_ended(a, **kwargs):
        return a

    kwargs = {"a": 1, "b": 2, "c": 3}
    for fn in (fixed, open_ended, tsp.NestedResUNet):
        assert tmisc.filter_kwargs(fn, kwargs) == jmisc.filter_kwargs(fn, kwargs)
    assert tmisc.filter_kwargs(fixed, kwargs) == {"a": 1, "b": 2}


def test_remove_components_matches_jax(tmp_path):
    contexts = []
    for pkg in (jsp, tsp):
        context = pkg.Context(name="c")
        for name in ("model", "optimizer", "criterion", "trainer"):
            context.add_component(name, dict, value=name)
        context.remove_components(["optimizer", "criterion"])
        context.remove_component("trainer")
        contexts.append([d["name"] for d in context.component_definitions])
    assert contexts[1] == contexts[0] == ["model"]
    context = tsp.Context("cpu", name="c")
    context.add_component("model", dict)
    context.init_components()
    with pytest.raises(RuntimeError):
        context.remove_component("model")


@pytest.mark.parametrize("transformed", [False, True], ids=["raw", "transformed"])
def test_dataset_fingerprint_matches_jax(tmp_path, transformed):
    build_dataset(tmp_path, 3)
    out = {}
    for pkg in (jsp, tsp):
        loader = pkg.ComposeLoaders([
            pkg.ImageLoader(glob_pattern="t1.*", image_name="t1",
                            image_constructor=pkg.ScalarImage),
            pkg.ImageLoader(glob_pattern="seg.*", image_name="seg",
                            image_constructor=pkg.LabelMap, label_values={"fg": 1, "bg2": 2}),
        ])
        folder = pkg.SubjectFolder(str(tmp_path), "subjects", loader)
        transform = pkg.Compose([pkg.RescaleIntensity((-1, 1), (0.5, 99.5)),
                                 pkg.Crop((1, 2, 0, 3, 1, 0))]) if transformed else None
        fingerprints = pkg.get_dataset_fingerprint(folder, transform=transform, save=True)
        saved = [(tmp_path / "fingerprint" / name).read_text()
                 for name in ("subject_fingerprints.json", "fingerprint.json")]
        out[pkg] = fingerprints, saved
    (fingerprints, saved), (jfingerprints, jsaved) = out[tsp], out[jsp]
    assert saved == jsaved
    assert json.loads(saved[0]) == json.loads(jsaved[0])
    subjects, summary = fingerprints
    assert sorted(subjects) == ["sub-00", "sub-01", "sub-02"]
    assert subjects["sub-00"]["spatial_shape"] == ((13, 13, 7) if transformed else (16, 16, 8))
    assert "bg2" not in subjects["sub-00"]["label_bounds"]["seg"]  # absent labels are dropped
    assert summary["spacing"]["mean"] == jfingerprints[1]["spacing"]["mean"]


def test_profiler_trace_writes_a_trace_file(tmp_path):
    with ProfilerTrace(str(tmp_path)) as trace:
        torch.ones(8, 8) @ torch.ones(8, 8)
    [path] = list(tmp_path.glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    assert trace.profile is not None and any("mm" in e.get("name", "") for e in events)
