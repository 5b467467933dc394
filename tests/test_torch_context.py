"""The port's Context against the JAX package's on the CPU: ``Ref`` and
``$VAR`` expansion, the component-definition edits, ``get_config`` of the
ported dmri_hippo and msseg2 configurations against JAX's own, and
checkpoints: a save and a reload by file path give the same model outputs
and trainer state, states are host numpy copies, module-level functions
pickle by reference, closures through cloudpickle, and a failed write
leaves no file behind."""
import pickle

import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo.configs import main_config as jhippo
from research.msseg2 import msseg2 as jmsseg2
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as thippo
from segmentation_pipeline_torch.research.msseg2 import msseg2 as tmsseg2
from segmentation_pipeline_torch.training import context as tcontext

torch.set_num_threads(2)


class Holder:
    def __init__(self, value=None, path=None, scorer=None):
        self.value, self.path, self.scorer = value, path, scorer


def module_level_score(evaluation_dict):
    return 1.0


@pytest.mark.parametrize("pkg", [jsp, tsp], ids=["jax", "port"])
def test_ref_and_variable_expansion(pkg, monkeypatch, tmp_path):
    """A Ref resolves to an earlier component (or its attribute), and $VAR
    strings expand from the variables dict, in both packages alike."""
    monkeypatch.delenv("SPT_TEST_ROOT", raising=False)
    context = pkg.Context("cpu", name="refs", variables={"SPT_TEST_ROOT": str(tmp_path)})
    context.add_component("a", Holder, value=3, path="$SPT_TEST_ROOT/data")
    context.add_component("b", Holder, value=pkg.Ref("a"), path=pkg.Ref("a", "path"))
    context.update_component("a", value=4)
    context.init_components()
    assert context.a.path == f"{tmp_path}/data"
    assert context.b.value is context.a and context.a.value == 4
    assert context.b.path == context.a.path
    with pytest.raises(RuntimeError):
        context.add_component("c", Holder)


@pytest.mark.parametrize("name", ["dmri_hippo", "msseg2"])
def test_config_keys_and_values_match_jax(name):
    """get_config() of each ported configuration: JAX's keys; the plain
    values (numbers, strings, lists of them, None) equal; the reprs of
    constructed objects differ only by package."""
    jconfig, tconfig = {"dmri_hippo": (jhippo, thippo), "msseg2": (jmsseg2, tmsseg2)}[name]
    variables = {"DATASET_PATH": "/data"}
    j = jconfig.get_context(variables=variables).get_config()
    t = tconfig.get_context(device="cpu", variables=variables).get_config()
    assert list(t) == list(j)
    plain = 0
    for key, value in j.items():
        if isinstance(value, (int, float, bool, list, type(None))) or \
                (isinstance(value, str) and not value.startswith(("<", "[<", "{"))
                 and "(" not in value):
            assert t[key] == value, key
            plain += 1
        else:
            assert type(t[key]) is type(value), key
    assert plain >= 10
    assert t["trainer.compute_dtype"] is None and t["trainer.device_cache"] is False


def test_tpu_fast_path_raises():
    """tpu_fast_path=True sets JAX's levers, device_cache and "auto"
    device augmentation. A hybrid split (a host channel resynthesis) with
    the device cache raised here until training/hybrid_augment.py was
    ported; now it resolves to the device window plus the per-batch host
    stage, as in JAX."""
    from test_torch_trainer import Resynthesize

    variables = {"DATASET_PATH": "/data"}
    for jconfig, tconfig in ((jhippo, thippo), (jmsseg2, tmsseg2)):
        j = jconfig.get_context(variables=variables, tpu_fast_path=True).get_config()
        t = tconfig.get_context(device="cpu", variables=variables, tpu_fast_path=True).get_config()
        for key in ("trainer.device_cache", "trainer.device_augmentation"):
            assert t[key] == j[key], key
        assert (t["trainer.device_cache"], t["trainer.device_augmentation"]) == (True, "auto")
        context = tconfig.get_context(device="cpu", variables=variables, tpu_fast_path=True)
        params = context.get_component_definition("trainer")["params"]
        trainer = tsp.SegmentationTrainer(**params)
        dataset = tsp.SubjectFolder.__new__(tsp.SubjectFolder)
        dataset.transform = tsp.Compose([
            Resynthesize(), tsp.RandomNoise(std=0.1, p=0.5),
            tsp.ConcatenateImages(image_names=["t1"], image_channels=[1], new_image_name="X")])
        device_aug, _ = trainer._resolve_device_augmentation(dataset)
        assert device_aug["noise_p"] == 0.5
        assert trainer._resolved_hybrid_spec.image_order == ["t1"]
        assert [type(t).__name__ for t in trainer._resolved_hybrid_spec.peeled] == \
            ["Resynthesize"]


def _tiny_context(tmp_path, scorer=module_level_score):
    context = tsp.Context("cpu", name="ckpt", variables={"DATASET_PATH": str(tmp_path)})
    context.add_component("model", tsp.NestedResUNet, input_channels=1, output_channels=2,
                          filters=2)
    context.add_component("holder", Holder, value=[1, 2], scorer=scorer)
    return context


def test_save_and_reload_give_the_same_model_and_state(tmp_path):
    """A checkpoint holds numpy copies of the model's state (it loads with
    no GPU); reloaded by file path, the model answers the same."""
    context = _tiny_context(tmp_path)
    context.init_components()
    context.model.ensure_initialized()
    path = tmp_path / "a.ckpt"
    context.save(path)
    assert not (tmp_path / "a.ckpt.tmp").exists()
    state = pickle.load(open(path, "rb"))["component_definitions"][0]["state_dict"]
    assert all(isinstance(v, np.ndarray) for v in state.values())
    restored = tsp.Context("cpu", file_path=str(path))
    restored.init_components()
    x = np.random.default_rng(0).normal(size=(1, 1, 16, 16, 8)).astype(np.float32)
    assert torch.equal(restored.model(x), context.model(x))
    assert restored.holder.scorer is module_level_score
    assert tsp.list_checkpoint_files(tmp_path) == [path]
    assert tsp.list_checkpoint_files(path) == [path]


def test_snapshot_copies_what_training_changes_in_place(tmp_path):
    """The snapshot's arrays share no memory with the live tensors: a later
    in-place change does not reach a snapshot taken before it."""
    context = _tiny_context(tmp_path)
    context.init_components()
    context.model.ensure_initialized()
    snapshot = context.snapshot()
    weight = next(context.model.module.parameters())
    before = weight.detach().clone()
    with torch.no_grad():
        weight.add_(1.0)
    name = next(iter(dict(context.model.module.named_parameters())))
    saved = snapshot["component_definitions"][0]["state_dict"][name]
    np.testing.assert_array_equal(saved, before.numpy())
    assert tcontext.to_host({"a": (weight,)})["a"][0] is not weight


def test_functions_pickle_by_reference_or_through_cloudpickle(tmp_path):
    """A module-level scoring function (as both ported configs define theirs)
    pickles by reference; a closure becomes cloudpickle bytes and comes back
    callable."""
    for config in (thippo, tmsseg2):
        snapshot = config.get_context(device="cpu", variables={"DATASET_PATH": "/d"}).snapshot()
        trainer = [d for d in snapshot["component_definitions"] if d["name"] == "trainer"][0]
        assert not isinstance(trainer["params"]["scoring_function"], tcontext._FunctionPayload)
        pickle.dumps(snapshot)

    offset = 2.0
    context = _tiny_context(tmp_path, scorer=lambda d: offset)
    path = tmp_path / "closure.ckpt"
    context.save(path)
    restored = tsp.Context("cpu", file_path=str(path))
    assert isinstance(restored.get_component_definition("holder")["params"]["scorer"],
                      tcontext._FunctionPayload)
    restored.init_components()
    assert restored.holder.scorer({}) == 2.0


def test_failed_write_leaves_no_file(tmp_path):
    target = tmp_path / "bad.ckpt"
    with pytest.raises(Exception):
        tsp.Context.write_snapshot({"unpicklable": lambda: None}, target)
    assert list(tmp_path.iterdir()) == []


def test_keep_components_and_context_default_device(tmp_path, monkeypatch):
    """keep_components drops definitions; a context with no device puts its
    model on the card, and raises without one."""
    context = _tiny_context(tmp_path)
    context.keep_components(("holder",))
    assert [d["name"] for d in context.component_definitions] == ["holder"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    context = tsp.Context(name="card")
    context.add_component("model", tsp.NestedResUNet, input_channels=1, output_channels=2,
                          filters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        context.init_components()
