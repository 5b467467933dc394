"""The fast training path (``tpu_fast_path=True``: the device cache and the
device augmentation derived from the declared pipeline) of both ported
configurations against the JAX package's, on the CPU.

Both configurations train a few iterations through ``get_context(...,
tpu_fast_path=True, device="cpu")`` and resolve the same device
augmentation as JAX's trainer does on the same folder; msseg2's batches
are the patches ``extract_patch`` cuts at the drawn starts. The frozen-
augmentation guard raises as JAX's does. With the cache on and every gate
of dmri_hippo's derived config at 0 (the rescales still run), dmri_hippo's
losses equal JAX's within 1e-5 per iteration from one host seed.

The loss run is free-running for five iterations, and does not start each
port step from JAX's state as tests/test_torch_trainer.py's ``follow_jax``
does: on this fixture two of the first six steps are ill-conditioned at the
level of Adam's moments. At the fifth step JAX against itself, with the two
subjects of the batch swapped, parts its first moment by 4.3e-3 (relative,
over the whole tree), beyond that helper's 1e-4; the batches of the two
packages agree to one float32 ulp. The losses stay within 1e-6 over the
five iterations."""
import json
import math

import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo.configs import main_config as jhippo
from research.msseg2 import msseg2 as jmsseg2
from segmentation_pipeline_torch.data.device_cache import DevicePatchCache
from segmentation_pipeline_torch.data.loader import extract_patch
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_torch.ops.augment import DMRI_REFERENCE_CONFIG
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as thippo
from segmentation_pipeline_torch.research.msseg2 import msseg2 as tmsseg2
from segmentation_pipeline_torch.training import auto_augment as taa
from segmentation_pipeline_tpu.training import auto_augment as jaa
from test_torch_msseg2_trainer import write_dataset as write_msseg2_dataset
from test_torch_subject_folder import write_hippo_dataset

torch.set_num_threads(2)

CROP, FILTERS = (16, 16, 8), 4
MS_PATCH, MS_FILTERS = 16, (4, 4, 8)
LOSS_ITERATIONS = 5
CONFIGS = {"dmri_hippo": {jsp: jhippo, tsp: thippo}, "msseg2": {jsp: jmsseg2, tsp: tmsseg2}}
# dmri_hippo's derived augmentation with every gate at 0: the three
# rescales are all that runs
GATES_ZERO = dict(DMRI_REFERENCE_CONFIG, flip_p=0.0, elastic_p=0.0, bias_p=0.0, gamma_p=0.0,
                  blur_p=0.0, noise_p=0.0)


class RecordingLogger(tsp.NonLogger):
    def __init__(self):
        self.records = []

    def log(self, log_dict):
        self.records.append(log_dict)


def fast_context(pkg, name, root, **config):
    kwargs = {"device": "cpu"} if pkg is tsp else {}
    sizes = (dict(crop_shape=CROP, filters=FILTERS, training_batch_size=2)
             if name == "dmri_hippo" else dict(patch_size=MS_PATCH, filters=MS_FILTERS))
    return CONFIGS[name][pkg].get_context(variables={"DATASET_PATH": str(root)},
                                          tpu_fast_path=True, **sizes, **kwargs, **config)


def jax_resolution(name, root):
    """JAX's trainer on the same folder, stopped after its set-up: the
    resolved device augmentation and the cache it built."""
    context = fast_context(jsp, name, root)
    context.init_components()
    context.trainer.train(context, max_iterations=0, logger=jsp.NonLogger())
    return context.trainer


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    hippo = tmp_path_factory.mktemp("hippo")
    write_hippo_dataset(hippo)
    ms = tmp_path_factory.mktemp("msseg2")
    write_msseg2_dataset(ms)
    return {"dmri_hippo": hippo, "msseg2": ms}


@pytest.mark.parametrize("name", ["dmri_hippo", "msseg2"])
def test_fast_path_trains_and_resolves_as_jax(roots, tmp_path, monkeypatch, capsys, name):
    sampled = []
    real_sample = DevicePatchCache.sample

    def recording_sample(cache, idx, generator):
        batch, starts = real_sample(cache, idx, generator)
        sampled.append((list(idx), {k: v.clone() for k, v in batch.items()}, starts.clone()))
        return batch, starts

    monkeypatch.setattr(DevicePatchCache, "sample", recording_sample)
    context = fast_context(tsp, name, roots[name])
    trainer_params = context.get_component_definition("trainer")["params"]
    assert trainer_params["device_cache"] is True
    assert trainer_params["device_augmentation"] == "auto"
    context.init_components()
    logger = tsp.FileLogger(str(tmp_path))
    tsp.seed_all(0)
    context.trainer.train(context, max_iterations=3, logger=logger)
    out = capsys.readouterr().out
    records = [json.loads(line) for line in open(logger.run_dir / "metrics.jsonl")]
    assert [r["iteration"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert "device_augmentation='auto'" in out and "Device cache:" in out
    phases = context.trainer.startup_phases
    assert set(phases) == {"pretransform_s", "cache_build_s"}

    jtrainer = jax_resolution(name, roots[name])
    assert context.trainer.resolved_device_augmentation == jtrainer.resolved_device_augmentation
    assert not taa.contains_random(context.trainer._cache_dataset.transform)
    if name == "dmri_hippo":
        assert "elastic(p=0.5)" in out and "blur(p=0.2)" in out
        assert not sampled
        return
    assert "oneof(p=0.75, affine_w=0.80)" in out and "permute(p=1.0)" in out
    assert "training_segmentation_eval" in records[0]  # the lazy patch subjects
    # the patch cache's batches: extract_patch of the pretransformed
    # subjects at the drawn starts (one-hot labels as uint8 ids)
    subjects = context.trainer._cache_dataset.subjects
    assert len(sampled) == 4  # three iterations and the prefetch of a fourth
    for idx, batch, starts in sampled:
        for k, i in enumerate(idx):
            patch = extract_patch(subjects[i], starts[k].numpy(), MS_PATCH)
            np.testing.assert_array_equal(batch["X"][k].numpy(),
                                          np.moveaxis(np.asarray(patch["X"].data), 0, -1))
            np.testing.assert_array_equal(batch["y"][k].numpy(),
                                          np.asarray(patch["y"].data).argmax(0))


@pytest.mark.parametrize("pkg", [jsp, tsp], ids=["jax", "port"])
def test_frozen_augmentation_guard(roots, pkg):
    """The cache without the device augmentation would freeze the declared
    random transforms into one draw: both trainers refuse."""
    context = fast_context(pkg, "dmri_hippo", roots["dmri_hippo"])
    context.update_component("trainer", device_augmentation=None)
    context.init_components()
    with pytest.raises(ValueError, match="FREEZE"):
        context.trainer.train(context, max_iterations=1, logger=pkg.NonLogger())


def loss_run(pkg, root, state):
    context = fast_context(pkg, "dmri_hippo", root)
    context.update_component("model", dropout_p=0.0)
    context.update_component("trainer", device_augmentation=GATES_ZERO, training_evaluators=[],
                             validation_evaluators=[], scoring_function=None)
    transforms = context.get_component_definition("dataset")["params"]["transforms"]
    aa = taa if pkg is tsp else jaa
    transforms["training"], _ = aa.derive_device_augmentation(transforms["training"])
    context.init_components()
    context.model.load_state_dict(state if pkg is tsp else state_dict_to_flax(state))
    pkg.seed_all(3)
    logger = RecordingLogger()
    context.trainer.train(context, max_iterations=LOSS_ITERATIONS, logger=logger)
    return context, logger.records


def test_dmri_losses_match_jax_with_the_gates_at_zero(roots):
    module = tsp.NestedResUNet(len(chip_smoke.INPUT_IMAGES), 2, filters=FILTERS)
    model = tsp.SegModel(module, device="cpu")
    model.ensure_initialized()
    state = {k: v.clone() for k, v in module.state_dict().items()}
    _, jrec = loss_run(jsp, roots["dmri_hippo"], state)
    context, trec = loss_run(tsp, roots["dmri_hippo"], state)
    assert context.trainer.resolved_device_augmentation == GATES_ZERO
    assert [r["iteration"] for r in trec] == [r["iteration"] for r in jrec] == \
        list(range(LOSS_ITERATIONS))
    for j, t in zip(jrec, trec):
        for key, scale in (("loss", 1.0), ("dice_loss", 1.0), ("logistic_loss", 0.0)):
            assert math.isclose(t[key], j[key], rel_tol=1e-5, abs_tol=1e-5 * scale), \
                (j["iteration"], key, t[key], j[key])
