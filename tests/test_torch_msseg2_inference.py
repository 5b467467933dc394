"""msseg2 serving, whole: a raw FLAIR pair and brain mask through msseg2's
``default`` pipeline, sliding-window PatchPredict on the BlurConv
ModularUNet, the inversion of the tape, the competition's cleanup and the
resample back onto the raw grid. JAX's own
research/msseg2/competition/ms_inference.py ``inference`` (which writes the
mask as NIfTI) against the port's CLI module
(segmentation_pipeline_torch/research/msseg2/competition/ms_inference.py),
at the same weights, on one subject that MinSizePad(96) pads to one 96^3 patch."""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.msseg2.competition import ms_inference
from research.msseg2.msseg2 import build_pipelines
from segmentation_pipeline_torch import prediction as tpred
from segmentation_pipeline_torch.research.msseg2.competition import ms_inference as port_cli
from segmentation_pipeline_torch.research.msseg2.msseg2 import build_pipelines as port_pipelines
from test_torch_patch_predict import TIE, msseg2_pair

torch.set_num_threads(2)

GRID = (40, 36, 30)
SPACING = (0.9375, 0.9375, 1.2)
SEMI_AXES_MM = (14.0, 12.0, 11.0)
FILTERS = (4, 4, 8)
SEED = 17


class Dataset:
    """What ms_inference.inference reads of a dataset: the raw subjects, and
    each transformed one by index."""

    def __init__(self, subjects, pipeline):
        self.subjects = subjects
        self.pipeline = pipeline

    def __len__(self):
        return len(self.subjects)

    def __getitem__(self, i):
        return self.pipeline(copy.deepcopy(self.subjects[i]))


def _raw(pkg):
    volumes, affine = chip_smoke.msseg2_volumes(np.random.default_rng(SEED), GRID, SPACING,
                                                SEMI_AXES_MM)
    return chip_smoke.msseg2_subject(pkg, volumes, affine, "sub-0")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jmodel, model = msseg2_pair(FILTERS, SEED)
    recorded = []

    class Recording(jsp.PatchPredict):
        def predict(self, model, subjects, label_attributes=None):
            subjects, batch = super().predict(model, subjects, label_attributes)
            recorded.append(np.array(subjects[0]["y_pred"].data))
            return subjects, batch

    out = tmp_path_factory.mktemp("msseg2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ms_inference, "PatchPredict", Recording)
        ms_inference.inference(Dataset([_raw(jsp)], build_pipelines(96)["default"]), jmodel,
                               str(out), "mask.nii.gz")
    jax_mask, jax_affine = jsp.read_nifti(out / "sub-0" / "mask.nii.gz")

    raw = _raw(tsp)
    subject = port_pipelines(port_cli.PATCH_SIZE)["default"](copy.deepcopy(raw))
    [subject], _ = port_cli.competition_predictor(False, device="cpu").predict(model,
                                                                              [subject])
    port_probs = np.array(subject["y_pred"].data)
    port_label, _ = port_cli.ms_to_raw_grid(subject, raw)
    return model, recorded[0], jax_mask, jax_affine, port_probs, port_label


def test_model_space_prediction_matches_jax(served):
    _, jax_probs, _, _, port_probs, _ = served
    assert port_probs.shape == jax_probs.shape == (2, 96, 96, 96)
    # probabilities after the network
    np.testing.assert_allclose(port_probs, jax_probs, atol=1e-4, rtol=0)
    clear = np.abs(port_probs[1] - port_probs[0]) >= TIE
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(port_probs.argmax(0)[clear], jax_probs.argmax(0)[clear])


def test_back_to_the_raw_grid_matches_jax_exactly(served):
    """The port's inversion, cleanup and resample on JAX's model-space
    prediction give JAX's NIfTI mask exactly."""
    _, jax_probs, jax_mask, jax_affine, _, _ = served
    raw = _raw(tsp)
    subject = port_pipelines(port_cli.PATCH_SIZE)["default"](copy.deepcopy(raw))
    tpred._attach_prediction(subject, jax_probs, None)
    label, _ = port_cli.ms_to_raw_grid(subject, raw)
    assert label.data.dtype == np.int32 and label.data.shape == (1, *GRID)
    np.testing.assert_array_equal(label.data, jax_mask)
    # NIfTI stores the affine in float32
    np.testing.assert_array_equal(label.affine.astype(np.float32), jax_affine.astype(np.float32))
    assert (label.data == 0).any() and (label.data == 1).any()


def test_answer_on_the_raw_grid(served):
    model, jax_probs, jax_mask, _, port_probs, port_label = served
    raw = _raw(tsp)
    assert port_label.data.shape == (1, *GRID) and set(np.unique(port_label.data)) <= {0, 1}
    np.testing.assert_array_equal(port_label.affine, raw["flair_time01"].affine)
    if np.array_equal(port_probs.argmax(0), jax_probs.argmax(0)):
        np.testing.assert_array_equal(port_label.data, jax_mask)
    # device_argmax answers with the full fetch's labels
    subject = port_pipelines(port_cli.PATCH_SIZE)["default"](copy.deepcopy(raw))
    label, _ = port_cli.ms_inference(subject, raw, model,
                                     port_cli.competition_predictor(True, device="cpu"))
    np.testing.assert_array_equal(label.data, port_label.data)
