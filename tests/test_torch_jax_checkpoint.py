"""The converter from a JAX checkpoint to the port's
(segmentation_pipeline_torch/utils/jax_checkpoint.py), on checkpoints the
JAX trainer writes for both configurations after one step on the CPU:
dmri_hippo (Adam; dropout 0, so that both packages take the same next
step) and msseg2 (SGD with momentum), each at a small size. The converted
Context, loaded by the port on the CPU, must answer the JAX model's
forward within 1e-5 of max|ref|, hold the same optimizer moments and step
count exactly, take the next step at JAX's loss (within 1e-5, as
tests/test_torch_trainer.py holds losses) from the same host seed, and
rebuild a dataset whose pipelines give JAX's subjects. Every object the
checkpoint pickles is restored with the attributes of the port's own
configuration. What the port cannot read raises naming it."""
import json
import math
import pickle

import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo.configs import main_config as jhippo
from research.msseg2 import msseg2 as jmsseg2
from segmentation_pipeline_tpu.loggers import FileLogger as JFileLogger
from segmentation_pipeline_tpu.training import context as jcontext
from segmentation_pipeline_torch.models import flax_to_state_dict
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as thippo
from segmentation_pipeline_torch.research.msseg2 import msseg2 as tmsseg2
from segmentation_pipeline_torch.utils import jax_checkpoint
from segmentation_pipeline_torch.utils.jax_checkpoint import (JaxCheckpointError,
                                                              convert_checkpoint_data,
                                                              convert_jax_checkpoint)
from test_torch_msseg2_trainer import write_dataset as write_msseg2_dataset
from test_torch_subject_folder import write_hippo_dataset
from test_torch_transforms import _assert_subjects_equal

torch.set_num_threads(2)

NAMES = ["dmri_hippo", "msseg2"]
CONFIGS = {"dmri_hippo": (jhippo, thippo), "msseg2": (jmsseg2, tmsseg2)}
SIZES = {"dmri_hippo": dict(crop_shape=(16, 16, 8), filters=4, training_batch_size=2),
         "msseg2": dict(patch_size=16, filters=(4, 4, 8))}
COHORTS = {"dmri_hippo": "cbbrain_validation", "msseg2": "validation"}
LOSS_RTOL = 1e-5
# state both packages' PatchPredict keep once a sweep has run (the patch
# batch after halving out of memory), absent from a fresh object
RUN_TIME_ATTRIBUTES = {"_effective_patch_batch"}


class RecordingLogger(tsp.NonLogger):
    def __init__(self):
        self.records = []

    def log(self, log_dict):
        self.records.append(log_dict)


def jax_context(name, root):
    """The JAX configuration at a small size (dmri_hippo without dropout)."""
    context = CONFIGS[name][0].get_context(variables={"DATASET_PATH": str(root)}, **SIZES[name])
    if name == "dmri_hippo":
        context.update_component("model", dropout_p=0.0)
    return context


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> (dataset root, JAX checkpoint after one step, converted)."""
    out = {}
    for name, write in (("dmri_hippo", write_hippo_dataset), ("msseg2", write_msseg2_dataset)):
        root = tmp_path_factory.mktemp(name)
        write(root)
        context = jax_context(name, root)
        context.init_components()
        jsp.seed_all(0)
        logger = JFileLogger(str(tmp_path_factory.mktemp(f"{name}-logs")))
        context.trainer.train(context, max_iterations=1, logger=logger)
        ckpt = sorted((logger.run_dir / "checkpoints").iterdir())[-1]
        [converted] = convert_jax_checkpoint(ckpt, tmp_path_factory.mktemp(name) / ckpt.name)
        out[name] = root, ckpt, converted
    return out


def loaded(pkg, ckpt, root):
    kwargs = {"device": "cpu"} if pkg is tsp else {}
    context = pkg.Context(file_path=str(ckpt), variables={"DATASET_PATH": str(root)}, **kwargs)
    context.init_components()
    return context


@pytest.mark.parametrize("name", NAMES)
def test_converted_forward_matches_jax(checkpoints, name):
    root, ckpt, converted = checkpoints[name]
    jctx, tctx = loaded(jsp, ckpt, root), loaded(tsp, converted, root)
    assert tctx.model.device == torch.device("cpu")
    assert tctx.trainer.validation_predictor.device == torch.device("cpu")
    shape = (1, 3, 16, 16, 8) if name == "dmri_hippo" else (1, 2, 16, 16, 16)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    ref = np.asarray(jctx.model(x))
    out = tctx.model(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("name", NAMES)
def test_converted_optimizer_state_matches_jax(checkpoints, name):
    """Adam's mu/nu/count as exp_avg/exp_avg_sq/step, SGD's momentum trace
    as momentum_buffer: equal exactly; the trainer's counters carried."""
    root, ckpt, converted = checkpoints[name]
    with open(ckpt, "rb") as f:
        jdefs = {d["name"]: d for d in pickle.load(f)["component_definitions"]}
    jstate = jdefs["trainer"]["state_dict"]
    tctx = loaded(tsp, converted, root)
    trainer = tctx.trainer
    assert (trainer.iteration, trainer.max_score, trainer.max_score_iteration) == \
        (jstate["iteration"], jstate["max_score"], jstate["max_score_iteration"]) == \
        (1, jstate["max_score"], 0)
    optimizer = trainer._optimizer_for(tctx.model, tctx.optimizer)
    params = tctx.model.params
    opt = jstate["opt_state"][0]
    if name == "dmri_hippo":
        assert isinstance(optimizer, torch.optim.Adam) and int(opt.count) == 1
        refs = {"exp_avg": flax_to_state_dict({"params": opt.mu}),
                "exp_avg_sq": flax_to_state_dict({"params": opt.nu})}
        for pname, param in params.items():
            state = optimizer.state[param]
            assert float(state["step"]) == 1.0
            for key, ref in refs.items():
                assert torch.equal(state[key], ref[pname]), (pname, key)
    else:
        assert isinstance(optimizer, torch.optim.SGD)
        ref = flax_to_state_dict({"params": opt.trace})
        for pname, param in params.items():
            assert torch.equal(optimizer.state[param]["momentum_buffer"], ref[pname]), pname
    assert optimizer.param_groups[0]["lr"] == tctx.get_component_definition(
        "optimizer")["params"]["lr"]


@pytest.mark.parametrize("name", NAMES)
def test_next_step_loss_matches_jax(checkpoints, name):
    """Both packages resume from the checkpoint and take one step from the
    same host seed: the losses agree within 1e-5."""
    root, ckpt, converted = checkpoints[name]
    records = {}
    for pkg, path in ((jsp, ckpt), (tsp, converted)):
        context = loaded(pkg, path, root)
        pkg.seed_all(7)
        logger = RecordingLogger()
        context.trainer.train(context, max_iterations=1, logger=logger)
        records[pkg] = [r for r in logger.records if "loss" in r]
    assert [r["iteration"] for r in records[tsp]] == [r["iteration"] for r in records[jsp]] \
        == [1]
    for key, scale in (("loss", 1.0), ("dice_loss", 1.0), ("logistic_loss", 0.0)):
        t, j = records[tsp][0][key], records[jsp][0][key]
        assert math.isclose(t, j, rel_tol=LOSS_RTOL, abs_tol=LOSS_RTOL * scale), (key, t, j)


@pytest.mark.parametrize("name", NAMES)
def test_converted_dataset_gives_jax_subjects(checkpoints, name):
    """The dataset component rebuilt from the converted checkpoint: its
    ``default`` pipeline gives JAX's subject and tape exactly, and its
    ``training`` pipeline the same draws from the same seed."""
    root, ckpt, converted = checkpoints[name]
    datasets = {pkg: loaded(pkg, path, root).dataset
                for pkg, path in ((jsp, ckpt), (tsp, converted))}
    subjects = {pkg: ds.get_cohort_dataset(COHORTS[name])[0] for pkg, ds in datasets.items()}
    _assert_subjects_equal(subjects[jsp], subjects[tsp])
    tapes = [[(type(r.transform).__name__, repr(r.args)) for r in subjects[pkg].history]
             for pkg in (jsp, tsp)]
    assert tapes[0] == tapes[1]
    for pkg, ds in datasets.items():
        training = ds.get_cohort_dataset("training")
        pkg.seed_all(3)
        subjects[pkg] = training[0]
    _assert_subjects_equal(subjects[jsp], subjects[tsp])


def _objects(value, path, out):
    """Every object of either package reachable from ``value``: path ->
    (class name, attribute names)."""
    if isinstance(value, dict):
        for k, v in value.items():
            _objects(v, f"{path}.{k}", out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _objects(v, f"{path}[{i}]", out)
    elif type(value).__module__.startswith(("segmentation_pipeline", "research")) \
            and hasattr(value, "__dict__") and not isinstance(value, type):
        out[path] = (type(value).__name__, sorted(set(vars(value)) - RUN_TIME_ATTRIBUTES))
        for k, v in vars(value).items():
            _objects(v, f"{path}.{k}", out)


@pytest.mark.parametrize("name", NAMES)
def test_converted_objects_have_the_port_attributes(checkpoints, name):
    """Every pickled object comes back as the port's class, with the
    attribute names of the port's own configuration's object at the same
    place (what the port renamed or dropped would restore silently wrong)."""
    root, _, converted = checkpoints[name]
    with open(converted, "rb") as f:
        checkpoint = pickle.load(f)
    own = CONFIGS[name][1].get_context(device="cpu", variables={"DATASET_PATH": str(root)},
                                       **SIZES[name])
    assert [d["name"] for d in checkpoint["component_definitions"]] == \
        [d["name"] for d in own.component_definitions]
    for got, want in zip(checkpoint["component_definitions"], own.component_definitions):
        assert got["constructor"] is want["constructor"], got["name"]
        assert got["constructor"].__module__.startswith("segmentation_pipeline_torch")
        objects = [{}, {}]
        for params, out in zip((got["params"], want["params"]), objects):
            _objects(params, got["name"], out)
        assert objects[0] == objects[1], got["name"]
        assert not [p for p, (cls, _) in objects[0].items() if "tpu" in cls]


def _jax_payload(checkpoint_path, change):
    """The JAX checkpoint's bytes, with ``change`` made to its payload."""
    with open(checkpoint_path, "rb") as f:
        checkpoint = pickle.load(f)
    change(checkpoint)
    return pickle.dumps(checkpoint)


def _trainer(checkpoint):
    return next(d for d in checkpoint["component_definitions"] if d["name"] == "trainer")


def test_unported_contents_raise_naming_their_item(checkpoints):
    """orbax array storage stays out by design (it needs JAX): the message
    says how to re-save; a W-sharded PatchPredict (volume_sharded) waits
    for item 10b."""
    _, ckpt, _ = checkpoints["dmri_hippo"]
    _, ms_ckpt, _ = checkpoints["msseg2"]

    def orbax(c):
        c["array_storage"] = "orbax"

    with pytest.raises(NotImplementedError, match='array_storage="pickle"'):
        convert_checkpoint_data(_jax_payload(ckpt, orbax))

    def sharded(c):
        _trainer(c)["params"]["validation_predictor"].volume_sharded = True

    with pytest.raises(NotImplementedError, match="item 10b"):
        convert_checkpoint_data(_jax_payload(ms_ckpt, sharded))


def test_meshes_convert(checkpoints, tmp_path):
    """A JAX checkpoint whose trainer and PatchPredict hold meshes (pickled
    as JAX stores them, as recipes) converts: the port's context rebuilds
    the trainer's mesh over this process at load, the predictor keeps its
    recipe until its first predict, and that predict over the one-rank mesh
    gives the predictor's answer without a mesh, which is JAX's."""
    import jax

    root, ms_ckpt, _ = checkpoints["msseg2"]

    def mesh(c):
        _trainer(c)["params"]["validation_predictor"].mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:1]), ("data",))
        _trainer(c)["params"]["mesh"] = jsp.MeshRecipe(("data", "model"), (1, 1))

    converted = tmp_path / "mesh.ckpt"
    tsp.Context.write_snapshot(convert_checkpoint_data(_jax_payload(ms_ckpt, mesh)), converted)
    context = loaded(tsp, converted, root)
    assert context.trainer.mesh.shape == {"data": 1, "model": 1}
    predictor = context.trainer.validation_predictor
    assert isinstance(predictor.mesh, tsp.MeshRecipe) and predictor.mesh.shape == (1,)
    subject = context.dataset.get_cohort_dataset(COHORTS["msseg2"])[0]
    outs = []
    for mesh_of in (lambda: predictor.mesh, lambda: None):
        predictor.mesh = mesh_of()
        _, batch = predictor.predict(context.model, [subject])
        outs.append(batch["y_pred"])
    assert predictor.mesh is None and outs[0].shape == outs[1].shape
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-6)


def test_process_workers_convert(checkpoints, tmp_path):
    """A JAX checkpoint whose loader factory uses process workers converts;
    the port's factory keeps the flag and its loader's batches, fetched by
    two worker processes, equal the serial loader's."""
    root, ckpt, _ = checkpoints["dmri_hippo"]

    def processes(c):
        _trainer(c)["params"]["validation_dataloader_factory"].use_processes = True

    converted = tmp_path / "processes.ckpt"
    tsp.Context.write_snapshot(convert_checkpoint_data(_jax_payload(ckpt, processes)), converted)
    context = loaded(tsp, converted, root)
    factory = context.trainer.validation_dataloader_factory
    assert type(factory) is tsp.StandardDataLoader and factory.use_processes
    dataset = context.dataset.get_cohort_dataset(COHORTS["dmri_hippo"])
    try:
        batches = list(factory.get_data_loader(dataset, batch_size=2, num_workers=2))
    finally:
        factory.close_pools()
    serial = [dataset[i] for i in range(len(dataset))]
    assert [s["name"] for b in batches for s in b] == [s["name"] for s in serial]
    for got, want in zip((s for b in batches for s in b), serial):
        np.testing.assert_array_equal(got["X"].data, want["X"].data)


def test_cascade_checkpoint_converts(checkpoints, tmp_path):
    """A checkpoint of the cascade context (configs/cascade.py: the prior
    loader, the StochasticMatrix head, refine_image predictors, SGD) loads
    in the port with all of them, and its model answers as JAX's; a
    refine_image set on another context's predictor carries over too."""
    from research.dmri_hippo.configs import cascade as jcascade

    root, ckpt, _ = checkpoints["dmri_hippo"]
    predictions = tmp_path / "predictions"
    import chip_smoke

    chip_smoke.write_priors(str(root), str(predictions), 1)
    variables = {"DATASET_PATH": str(root), "PREDICTIONS_PATH": str(predictions)}
    jctx = jcascade.get_context(variables=variables, **SIZES["dmri_hippo"])
    jctx.init_components()
    x = np.random.default_rng(6).normal(size=(1, 3, 16, 16, 8)).astype(np.float32)
    ref = np.asarray(jctx.model(x))
    jctx.save(tmp_path / "cascade.ckpt")
    [converted] = convert_jax_checkpoint(tmp_path / "cascade.ckpt", tmp_path / "port.ckpt")
    tctx = tsp.Context("cpu", file_path=str(converted), variables=variables)
    tctx.init_components()
    assert type(tctx.model.module.hypothesis).__name__ == "StochasticMatrix"
    assert tctx.model.module.hypothesis.channels == 2
    for predictor in (tctx.trainer.train_predictor, tctx.trainer.validation_predictor):
        assert predictor.refine_image == "y_prior" and "y_prior" in predictor.image_names
        assert predictor.device == torch.device("cpu")
    assert tctx.get_component_definition("optimizer")["constructor"] is tsp.SGD
    out = tctx.model(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 4, 16, 16, 8)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert "y_prior" in tctx.dataset.get_cohort_dataset("cbbrain_validation")[0]

    def refine(c):
        _trainer(c)["params"]["train_predictor"].refine_image = "y_prior"

    restored = convert_checkpoint_data(_jax_payload(ckpt, refine))
    assert _trainer(restored)["params"]["train_predictor"].refine_image == "y_prior"


def _find(value, cls_name, seen=None):
    """Every object of class ``cls_name`` reachable from ``value``."""
    seen = set() if seen is None else seen
    if id(value) in seen:
        return []
    seen.add(id(value))
    if isinstance(value, dict):
        return [o for v in value.values() for o in _find(v, cls_name, seen)]
    if isinstance(value, (list, tuple)):
        return [o for v in value for o in _find(v, cls_name, seen)]
    if hasattr(value, "__dict__") and not isinstance(value, type) \
            and type(value).__module__.startswith(("segmentation_pipeline", "research")):
        found = [value] if type(value).__name__ == cls_name else []
        return found + _find(vars(value), cls_name, seen)
    return []


def test_resample_and_image_from_labels_options_convert(checkpoints):
    """TargetResample's pre_affine_name and scalars_only and ImageFromLabels'
    mode, which the port now has, convert with their values."""
    _, ms_ckpt, _ = checkpoints["msseg2"]

    def options(c):
        dataset = next(d for d in c["component_definitions"] if d["name"] == "dataset")
        for t in _find(dataset["params"], "TargetResample"):
            t.pre_affine_name, t.scalars_only = "flair_time01", True
        for t in _find(dataset["params"], "ImageFromLabels"):
            t.mode = "additive"

    converted = convert_checkpoint_data(_jax_payload(ms_ckpt, options))
    dataset = next(d for d in converted["component_definitions"] if d["name"] == "dataset")
    resamples = _find(dataset["params"], "TargetResample")
    weights = _find(dataset["params"], "ImageFromLabels")
    assert resamples and weights
    assert all(isinstance(t, tsp.TargetResample) and t.pre_affine_name == "flair_time01"
               and t.scalars_only for t in resamples)
    assert all(isinstance(t, tsp.ImageFromLabels) and t.mode == "additive" for t in weights)


def _closure_checkpoint(fn):
    """A JAX checkpoint whose criterion params hold a closure, stored as
    the JAX Context stores what stdlib pickle refuses."""
    context = jsp.Context(name="closure")
    context.add_component("criterion", jsp.HybridLogisticDiceLoss)
    checkpoint = context.snapshot()
    checkpoint["component_definitions"][0]["params"] = jcontext._make_picklable({"fn": fn})
    return pickle.dumps(checkpoint)


def test_closures_convert_or_raise_naming_jax():
    """A closure over numpy converts and runs in the port; one over
    jax.numpy raises naming the module."""
    import jax.numpy as jnp

    scale = 3.0
    converted = convert_checkpoint_data(_closure_checkpoint(lambda x: float(np.sum(x)) * scale))
    payload = converted["component_definitions"][0]["params"]["fn"]
    assert isinstance(payload, tsp.training.context._FunctionPayload)
    assert payload.load()(np.ones(4)) == 12.0
    with pytest.raises(JaxCheckpointError, match="jax"):
        convert_checkpoint_data(_closure_checkpoint(lambda x: float(jnp.sum(x)) * scale))


def test_folder_conversion_and_command_line(checkpoints, tmp_path, capsys):
    root, ckpt, converted = checkpoints["dmri_hippo"]
    jax_checkpoint.main([str(ckpt.parent), str(tmp_path / "out")])
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == sorted(p.name for p in ckpt.parent.iterdir())
    assert capsys.readouterr().out.split() == [str(tmp_path / "out" / n) for n in written]
    with open(tmp_path / "out" / ckpt.name, "rb") as a, open(converted, "rb") as b:
        got, want = pickle.load(a), pickle.load(b)
    assert json.dumps(got["config"], sort_keys=True) == json.dumps(want["config"], sort_keys=True)
    model = {d["name"]: d for d in got["component_definitions"]}["model"]["state_dict"]
    same = {d["name"]: d for d in want["component_definitions"]}["model"]["state_dict"]
    assert model.keys() == same.keys()
    assert all(np.array_equal(model[k], same[k]) for k in model)


def test_a_card_context_raises_without_a_gpu(checkpoints, monkeypatch):
    """The converted checkpoint loads on the card unless the caller asks for
    the CPU: without a GPU, a Context with no device raises."""
    root, _, converted = checkpoints["dmri_hippo"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    context = tsp.Context(file_path=str(converted), variables={"DATASET_PATH": str(root)})
    with pytest.raises(RuntimeError, match="CUDA"):
        context.init_components()
