"""The port's cascade (ROADMAP item 5) against the JAX package's on the CPU,
on numpy inputs made from a seed: StochasticMatrix with and without
diag_bias, the cascade NestedResUNet and ``basic_unet`` ModularUNet at
converted flax weights, apply_stochastic_matrix, StandardPredict with
refine_image, the configuration's subjects (the prior loaded, remapped and
one-hot) and two trainer steps of the cascade context. Tolerance: f32
within 1e-5 relative, the tapes' label ids exactly."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo.configs import cascade as jcascade
from segmentation_pipeline_tpu import prediction as jpred
from segmentation_pipeline_tpu.loggers import FileLogger as JFileLogger
from segmentation_pipeline_tpu.models import components as jcomp
from segmentation_pipeline_tpu.training import trainer as jtrainer
from segmentation_pipeline_torch import prediction as tpred
from segmentation_pipeline_torch.models import (StochasticMatrix, flax_to_state_dict,
                                                state_dict_to_flax)
from segmentation_pipeline_torch.research.dmri_hippo.configs import cascade as tcascade
from segmentation_pipeline_torch.training import trainer as ttrainer
from test_torch_subject_folder import write_hippo_dataset

torch.set_num_threads(2)

RTOL = 1e-5
CROP = (16, 16, 8)


def close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("channels, diag_bias", [(2, None), (2, 5.0), (4, None), (3, -1.5)])
def test_stochastic_matrix_matches_jax(channels, diag_bias):
    x = np.random.default_rng(channels).normal(0, 2, (2, 5, 4, 3, channels ** 2)).astype(
        np.float32)
    ref = jcomp.StochasticMatrix(channels, diag_bias).apply({}, jnp.asarray(x))
    out = StochasticMatrix(channels, diag_bias)(torch.from_numpy(x))
    close(out, ref)
    # each transition matrix is column-stochastic
    np.testing.assert_allclose(out.reshape(2, 5, 4, 3, channels, channels).sum(-2).numpy(),
                               1.0, atol=1e-6)
    assert list(StochasticMatrix(channels).parameters()) == []
    with pytest.raises(RuntimeError, match="square"):
        StochasticMatrix(channels)(torch.zeros(1, channels ** 2 + 1))


def test_apply_stochastic_matrix_matches_jax():
    rng = np.random.default_rng(1)
    C = 3
    y_pred = torch.softmax(torch.from_numpy(rng.normal(size=(2, C, C, 4, 5, 6)).astype(
        np.float32)), dim=1).reshape(2, C * C, 4, 5, 6)
    prior = rng.dirichlet(np.ones(C), size=(2, 4, 5, 6)).astype(np.float32).transpose(
        0, 4, 1, 2, 3)
    out = tpred.apply_stochastic_matrix(y_pred, torch.from_numpy(np.ascontiguousarray(prior)))
    close(out, jpred.apply_stochastic_matrix(jnp.asarray(y_pred.numpy()), jnp.asarray(prior)))
    # a column-stochastic update of a distribution is a distribution
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, atol=1e-6)


def _network_pair(pkg_cascade_args, seed):
    """The cascade context's model in both packages at the same random
    weights (the port's init converted to the flax tree)."""
    jctx = jcascade.get_context(**pkg_cascade_args)
    tctx = tcascade.get_context(device="cpu", **pkg_cascade_args)
    defn = tctx.get_component_definition("model")
    torch.manual_seed(seed)
    module = defn["constructor"](**defn["params"])
    state = module.state_dict()
    jdefn = jctx.get_component_definition("model")
    jmodel = jsp.SegModel(jdefn["constructor"](**jdefn["params"]))
    jmodel.load_state_dict(state_dict_to_flax(state))
    model = tsp.SegModel(module, device="cpu")
    model.load_state_dict(state)
    return jmodel, model


@pytest.mark.parametrize("model_type, predict_hbt", [(None, False), (None, True),
                                                     ("basic_unet", False)])
def test_cascade_networks_match_jax(model_type, predict_hbt):
    args = dict(variables={"DATASET_PATH": "/nonexistent", "PREDICTIONS_PATH": "/nonexistent"},
                model_type=model_type, predict_hbt=predict_hbt, crop_shape=CROP, filters=4)
    jmodel, model = _network_pair(args, seed=3)
    if model_type == "basic_unet":
        assert type(model.module).__name__ == "ModularUNet"
        assert model.module.hypothesis.diag_bias == 5
    C = 4 if predict_hbt else 2
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 8, 16, 8)).astype(np.float32)
    ref = np.asarray(jmodel(x))
    out = model(torch.from_numpy(x))
    assert out.shape == (2, C * C, 8, 16, 8)
    close(out.detach(), ref)
    # the converted tree goes back to the port's state exactly (the head has
    # no weights)
    back = flax_to_state_dict(state_dict_to_flax(model.module.state_dict()))
    assert back.keys() == model.module.state_dict().keys()


def write_priors(root, predictions, seed=0):
    return chip_smoke.write_priors(str(root), str(predictions), seed)


@pytest.fixture(scope="module")
def cascade_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("hippo")
    write_hippo_dataset(root)
    predictions = tmp_path_factory.mktemp("predictions")
    write_priors(root, predictions, seed=5)
    return root, predictions


def _contexts(cascade_root, **kwargs):
    root, predictions = cascade_root
    variables = {"DATASET_PATH": str(root), "PREDICTIONS_PATH": str(predictions)}
    args = dict(variables=variables, crop_shape=CROP, filters=4, training_batch_size=2, **kwargs)
    return jcascade.get_context(**args), tcascade.get_context(device="cpu", **args)


def test_prior_loads_remaps_and_one_hots_like_jax(cascade_root):
    jctx, tctx = _contexts(cascade_root)
    for ctx in (jctx, tctx):
        ctx.init_components()
    jdata = jctx.dataset.get_cohort_dataset("cbbrain_validation")
    tdata = tctx.dataset.get_cohort_dataset("cbbrain_validation")
    assert len(jdata) == len(tdata) > 0
    for i in range(len(tdata)):
        js, ts = jdata[i], tdata[i]
        assert ts["y_prior"].data.shape == (2, *CROP)
        np.testing.assert_array_equal(ts["y_prior"].data, js["y_prior"].data)
        np.testing.assert_array_equal(ts["y"].data, js["y"].data)
        # the prior is not the target: voxels were flipped
        assert not np.array_equal(ts["y_prior"].data, ts["y"].data)


def test_refined_standard_predict_matches_jax(cascade_root):
    """StandardPredict(sagittal_split=True, refine_image='y_prior') on the
    validation subjects: the refined probabilities, and y_prior joins the
    image names."""
    jctx, tctx = _contexts(cascade_root)
    for ctx in (jctx, tctx):
        ctx.init_components()
    tctx.model.ensure_initialized()
    jctx.model.load_state_dict(state_dict_to_flax(tctx.model.module.state_dict()))
    jpredictor = jctx.trainer.validation_predictor
    tpredictor = tctx.trainer.validation_predictor
    assert tpredictor.image_names == jpredictor.image_names == ["X", "y_prior"]
    jdata = jctx.dataset.get_cohort_dataset("cbbrain_validation")
    tdata = tctx.dataset.get_cohort_dataset("cbbrain_validation")
    jsubjects, jbatch = jpredictor.predict(jctx.model, [jdata[i] for i in range(len(jdata))])
    tsubjects, tbatch = tpredictor.predict(tctx.model, [tdata[i] for i in range(len(tdata))])
    close(tbatch["y_pred"].detach(), np.asarray(jbatch["y_pred"]))
    for js, ts in zip(jsubjects, tsubjects):
        close(ts["y_pred"].data, js["y_pred"].data)
    np.testing.assert_allclose(tbatch["y_pred"].sum(1).detach().numpy(), 1.0, atol=1e-6)
    # device_argmax gives the argmax of the same refinement
    tpredictor.device_argmax = True
    again, _ = tpredictor.predict(tctx.model, [tdata[i] for i in range(len(tdata))])
    for s, ref in zip(again, tsubjects):
        np.testing.assert_array_equal(s["y_pred"].data.argmax(0), ref["y_pred"].data.argmax(0))


def record_jax_states(monkeypatch):
    """Make the JAX trainer's steps record the state each starts from."""
    recorded = []
    make = jtrainer.make_train_step

    def recording_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def recording_step(state, batch, rng):
            recorded.append(jax.tree_util.tree_map(
                np.asarray, (state.params, state.batch_stats, state.opt_state)))
            return step(state, batch, rng)
        return recording_step

    monkeypatch.setattr(jtrainer, "make_train_step", recording_make)
    return recorded


def follow_jax_sgd(monkeypatch, recorded, carried):
    """Make the port's i-th step start from the JAX run's i-th state (the
    weights, the BatchNorm statistics and SGD's momentum trace), keeping the
    state the port carried into it in ``carried``."""
    make = ttrainer.make_train_step

    def following_make(module, *args, **kwargs):
        assert kwargs.get("refine_image") == "y_prior"
        step = make(module, *args, **kwargs)
        calls = iter(recorded)

        def following_step(state, batch, generator):
            params, batch_stats, opt_state = next(calls)
            assert batch["y_prior"].shape == (*batch["X"].shape[:4], 2)
            weights = flax_to_state_dict({"params": params, "batch_stats": batch_stats})
            trace = flax_to_state_dict({"params": opt_state[0].trace})
            live = module.state_dict()
            carried.append({n: live[n].clone() for n in weights})
            with torch.no_grad():
                for name, value in weights.items():
                    live[name].copy_(value)
            if len(carried) > 1:
                for name, param in state.params.items():
                    state.opt_state.state[param] = {"momentum_buffer": trace[name].clone()}
            return step(state, batch, generator)
        return following_step

    monkeypatch.setattr(ttrainer, "make_train_step", following_make)


@pytest.mark.parametrize("model_type", [None, "basic_unet"])
def test_two_trainer_steps_match_jax(cascade_root, tmp_path, monkeypatch, model_type):
    """Two iterations of the cascade context's trainer (SGD, the prior in
    the batch, the refined train step) from the same host seed on the
    deterministic pipeline at dropout 0: each step's losses within 1e-5 of
    JAX's, and the weights the port carried into step 2 within 1e-4 of
    JAX's (JAX's own one-step spread under reordered sums, see
    test_torch_trainer.py)."""
    contexts = _contexts(cascade_root, model_type=model_type)
    for ctx in contexts:
        transforms = ctx.get_component_definition("dataset")["params"]["transforms"]
        transforms["training"] = transforms["default"]
        params = ctx.get_component_definition("model")["params"]
        if model_type is None:
            params["dropout_p"] = 0.0
        trainer = ctx.get_component_definition("trainer")["params"]
        trainer["validation_evaluators"] = trainer["training_evaluators"] = []
        trainer["save_rate"] = 10 ** 6
        trainer["scoring_function"] = None
        ctx.init_components()
    jctx, tctx = contexts
    tctx.model.ensure_initialized()
    jctx.model.load_state_dict(state_dict_to_flax(tctx.model.module.state_dict()))
    recorded = record_jax_states(monkeypatch)
    records = {}
    for pkg, ctx, logger in ((jsp, jctx, JFileLogger), (tsp, tctx, tsp.FileLogger)):
        if pkg is tsp:
            carried = []
            follow_jax_sgd(monkeypatch, recorded, carried)
        pkg.seed_all(11)
        log = logger(str(tmp_path / pkg.__name__))
        ctx.trainer.train(ctx, max_iterations=2, logger=log)
        records[pkg] = [json.loads(line) for line in open(log.run_dir / "metrics.jsonl")]
    assert len(recorded) == 2 and len(carried) == 2
    for j, t in zip(records[jsp], records[tsp]):
        for key in ("loss", "dice_loss", "logistic_loss"):
            assert abs(t[key] - j[key]) <= RTOL * max(abs(j[key]), 1.0), (key, t[key], j[key])
    ref = flax_to_state_dict({"params": recorded[1][0], "batch_stats": recorded[1][1]})
    names = [n for n in ref if not n.endswith("num_batches_tracked")]
    port = torch.cat([carried[1][n].reshape(-1).double() for n in names])
    jax_w = torch.cat([ref[n].reshape(-1).double() for n in names])
    assert float((port - jax_w).norm() / jax_w.norm()) <= 1e-4
