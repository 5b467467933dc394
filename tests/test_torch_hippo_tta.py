"""The dmri_hippo TTA serving path, whole: raw subjects through the
``default`` pipeline, two folds each under batched flip TTA behind a
majority vote, StandardPredict with the sagittal split, the inversion back
to the scanner grid and the post-processing. JAX's own
research/dmri_hippo/hippo_inference.py ``inference`` and ``post_process`` on
JAX ensembles against the port's: the ``default`` pipeline of the ported
configuration (segmentation_pipeline_torch/research/dmri_hippo/configs/
main_config.py) and the port's CLI module
(segmentation_pipeline_torch/research/dmri_hippo/hippo_inference.py)."""
import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_torch as tsp
from research.dmri_hippo import hippo_inference
from research.dmri_hippo.configs.main_config import build_transforms
import segmentation_pipeline_tpu as jsp
from segmentation_pipeline_tpu.models import ensemble as jens
from segmentation_pipeline_torch import prediction as tpred
from segmentation_pipeline_torch.models import ensemble as tens
from segmentation_pipeline_torch.research.dmri_hippo import hippo_inference as port_cli
from segmentation_pipeline_torch.research.dmri_hippo.configs.main_config import \
    build_transforms as port_transforms
from test_torch_ensemble import model_pair, near_ties

torch.set_num_threads(2)

GRID = (20, 18, 6)
CROP = (16, 16, 8)
SEED = 11


class Recording:
    """A predictor that keeps a copy of each crop-space y_pred it attaches."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.y_pred = []

    def predict(self, model, subjects, label_attributes=None):
        subjects, batch = self.predictor.predict(model, subjects, label_attributes)
        self.y_pred = [np.array(s["y_pred"].data) for s in subjects]
        return subjects, batch


def _raw(pkg):
    rng = np.random.default_rng(SEED)
    return [chip_smoke.hippo_subject(pkg, *chip_smoke.hippo_volumes(rng, GRID), f"sub-{i}")
            for i in range(2)]


def _subjects(pkg, pipeline):
    return [pipeline(s) for s in _raw(pkg)]


def _tta(ens, folds):
    return ens.EnsembleModels([ens.EnsembleFlips(m, "majority", spatial_dims=(3, 4),
                                                 batched=True) for m in folds], "majority")


@pytest.fixture(scope="module")
def served():
    pairs = [model_pair(seed) for seed in (SEED, SEED + 1)]
    jax_predictor = Recording(jsp.StandardPredict(sagittal_split=True, image_names=["X"]))
    jax_subjects = hippo_inference.inference(
        _subjects(jsp, build_transforms(CROP, False)["default"]), jax_predictor,
        _tta(jens, [j for j, _ in pairs]))
    jax_reports = [hippo_inference.post_process(s["y_pred"]) for s in jax_subjects]

    port_predictor = Recording(tsp.StandardPredict(sagittal_split=True, image_names=["X"],
                                                   device="cpu"))
    port_subjects = port_cli.inference(
        _subjects(tsp, port_transforms(CROP, False)["default"]), port_predictor,
        _tta(tens, [m for _, m in pairs]))
    port_reports = [port_cli.post_process(s["y_pred"]) for s in port_subjects]
    return (pairs, jax_predictor.y_pred, jax_subjects, jax_reports,
            port_predictor.y_pred, port_subjects, port_reports)


def test_crop_space_labels_match_jax(served):
    """Crop-space labels of the fold-and-flip majority equal JAX's outside
    voxels where some member of some fold is near a tie."""
    pairs, jax_crop, _, _, port_crop, port_subjects, _ = served
    x = tsp.collate_subjects(_subjects(tsp, port_transforms(CROP, False)["default"]), ["X"],
                             device="cpu")["X"]
    members = []
    for _, model in pairs:
        flips = tens.EnsembleFlips(model, "majority", spatial_dims=(3, 4), batched=True)
        members += [tpred.reverse_split_and_flip(y)
                    for y in flips._members(tpred.split_and_flip(x))]
    ties = near_ties(members)
    assert ties.mean() < 0.01, ties.mean()
    for j, p, tie in zip(jax_crop, port_crop, ties):
        assert p.shape == j.shape == (2, *CROP)
        np.testing.assert_array_equal(np.argmax(p, 0)[~tie], np.argmax(j, 0)[~tie])


def test_inversion_and_post_processing_match_jax_exactly(served):
    """The port's inversion and post-processing on JAX's crop-space
    prediction give JAX's answers exactly, on the original grid."""
    _, jax_crop, jax_subjects, jax_reports, _, _, _ = served
    subjects = _subjects(tsp, port_transforms(CROP, False)["default"])
    for s, y in zip(subjects, jax_crop):
        tpred._attach_prediction(s, y, None)
    reports = [port_cli.post_process(s["y_pred"])
               for s in port_cli.invert_predictions(subjects)]
    assert reports == jax_reports
    for s, js in zip(subjects, jax_subjects):
        assert s["y_pred"].data.dtype == js["y_pred"].data.dtype == np.int32
        np.testing.assert_array_equal(s["y_pred"].data, js["y_pred"].data)
        np.testing.assert_array_equal(s["y_pred"].affine, js["y_pred"].affine)


def test_answers_on_the_original_grid(served):
    _, jax_crop, jax_subjects, jax_reports, port_crop, port_subjects, port_reports = served
    for s, raw in zip(port_subjects, _raw(tsp)):
        y = s["y_pred"]
        assert y.data.shape == (1, *GRID) and set(np.unique(y.data)) <= {0, 1, 2}
        np.testing.assert_array_equal(y.affine, raw["mean_dwi"].affine)
        assert (y.data == 1).any() and (y.data == 2).any()
    if all(np.array_equal(p.argmax(0), j.argmax(0)) for p, j in zip(port_crop, jax_crop)):
        assert port_reports == jax_reports
        for s, js in zip(port_subjects, jax_subjects):
            np.testing.assert_array_equal(s["y_pred"].data, js["y_pred"].data)
