"""msseg2's training loop in the port against the JAX package's on the CPU:
five raw subjects written in msseg2's layout by the port's NIfTI codec, each
package's own ``get_context`` (research/msseg2/msseg2.py and its port) at
filters (4, 4, 8), depth 3, with remat and 16^3 patches, the same weights,
``init_components`` and ``trainer.train`` for a few iterations from the same
host seed: the training pipeline's random transforms, the weighted patch
queue, SGD steps, the scheduled training and validation evaluators
(PatchPredict sweeps, contour images), the nan-aware lesion Dice score and
the checkpoints."""
import json
import math

import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.msseg2 import msseg2 as jmsseg2
from segmentation_pipeline_tpu.loggers import FileLogger as JFileLogger
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_torch.research.msseg2 import msseg2 as tmsseg2
from test_torch_trainer import same_logged

torch.set_num_threads(2)

FILTERS = (4, 4, 8)
PATCH = 16
ITERATIONS = 3
GRID = (40, 36, 30)
SEMI_AXES_MM = (14.0, 12.0, 11.0)


def write_dataset(root, n=5):
    """``n`` raw training subjects in msseg2's layout: one folder each with
    both FLAIRs, the brain mask and the lesion ground truth."""
    rng = np.random.default_rng(4)
    for i in range(n):
        volumes, affine = chip_smoke.msseg2_volumes(rng, GRID, chip_smoke.MS_RAW_SPACING,
                                                    SEMI_AXES_MM)
        folder = root / f"sub-{i:02d}"
        folder.mkdir(parents=True)
        for name in (*chip_smoke.MS_TIMEPOINTS, "brain_mask", "ground_truth"):
            tsp.write_nifti(folder / f"{name}.nii.gz", volumes[name], affine)


def run(pkg, config, root, logs, state):
    kwargs = {"device": "cpu"} if pkg is tsp else {}
    context = config.get_context(variables={"DATASET_PATH": str(root)}, patch_size=PATCH,
                                 filters=FILTERS, **kwargs)
    context.init_components()
    context.model.load_state_dict(state if pkg is tsp else state_dict_to_flax(state))
    pkg.seed_all(1)
    logger = (tsp.FileLogger if pkg is tsp else JFileLogger)(str(logs))
    context.trainer.train(context, max_iterations=ITERATIONS, logger=logger)
    records = [json.loads(line) for line in open(logger.run_dir / "metrics.jsonl")]
    return context, logger, records


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("msseg2")
    write_dataset(root)
    module = chip_smoke.msseg2_network(FILTERS)
    state = chip_smoke.msseg2_state(np.random.default_rng(9), module)
    return {pkg: run(pkg, config, root, tmp_path_factory.mktemp(pkg.__name__), state)
            for pkg, config in ((jsp, jmsseg2), (tsp, tmsseg2))}


def test_losses_match_jax(runs):
    """SGD steps on the same patches: each iteration's losses within 1e-5
    of JAX's, relative (the Dice loss, one minus a Dice score near one,
    relative to that unit-sized score)."""
    jrec, trec = runs[jsp][2], runs[tsp][2]
    assert [r["iteration"] for r in trec] == [r["iteration"] for r in jrec] == \
        list(range(ITERATIONS))
    for j, t in zip(jrec, trec):
        for key, scale in (("loss", 1.0), ("dice_loss", 1.0), ("logistic_loss", 0.0)):
            assert math.isclose(t[key], j[key], rel_tol=1e-5, abs_tol=1e-5 * scale), \
                (j["iteration"], key, t[key], j[key])


def test_schedule_scores_and_evaluators_match_jax(runs):
    """Iteration 0 carries every evaluator of the config, the score and a
    checkpoint: the same keys, the same score, the same Dice and volume
    tables; both write the same images and checkpoint files."""
    (_, jlog, jrec), (context, tlog, trec) = runs[jsp], runs[tsp]
    assert [sorted(set(t) - {"timer"}) for t in trec] == \
        [sorted(set(j) - {"timer"}) for j in jrec]
    assert {"training_segmentation_eval", "training_label_eval", "segmentation_eval",
            "model_score"} <= set(trec[0])
    assert math.isclose(trec[0]["model_score"], jrec[0]["model_score"], rel_tol=1e-9)
    for key in ("training_segmentation_eval", "training_label_eval", "segmentation_eval"):
        same_logged(trec[0][key], jrec[0][key], key)
    for folder in ("checkpoints", "best_checkpoints", "images"):
        assert sorted(p.name for p in (tlog.run_dir / folder).iterdir()) == \
            sorted(p.name for p in (jlog.run_dir / folder).iterdir()), folder
    assert context.trainer.iteration == ITERATIONS
