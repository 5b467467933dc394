"""A JAX qsm checkpoint taken in the middle of an accumulation window,
converted to the port's (segmentation_pipeline_torch/utils/jax_checkpoint.py):
the JAX trainer runs qsm's configuration with microbatch 2
(``Adam(accumulate_steps=2)``, optax.MultiStepsState) for one micro-step on
the CPU and saves; the converted checkpoint holds the same counters and
accumulated gradients, and both packages, resumed from their checkpoints
with the same host seed, take the next two micro-steps (the update, then a
banked step) to the same parameters."""
import pickle

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.qsm_deep_grey_matter import qsm_deep_grey_matter as jqsm
from segmentation_pipeline_torch.research.qsm_deep_grey_matter import qsm_deep_grey_matter as tqsm
from segmentation_pipeline_tpu.loggers import FileLogger as JFileLogger
from segmentation_pipeline_torch.models import flax_to_state_dict
from segmentation_pipeline_torch.utils.jax_checkpoint import (JaxCheckpointError,
                                                              convert_checkpoint_data,
                                                              convert_jax_checkpoint)
from test_torch_qsm import SMALL, write_qsm_dataset

torch.set_num_threads(2)

LR = 0.0002  # qsm's Adam
# crop (4, 4, 4, 4, 0, 0) of it: 16^3, three poolings deep
GRID = (24, 24, 16)


def _params(pkg, context):
    """The model's parameters as the port's state-dict keys, numpy."""
    if pkg is jsp:
        tree = {k: np.asarray(v) for k, v in flatten_dict(context.model.params).items()}
        return {k: v.numpy() for k, v in flax_to_state_dict(
            {"params": unflatten_dict(tree)}).items()}
    return {k: v.detach().numpy().copy() for k, v in context.model.params.items()}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(dataset root, the JAX checkpoint after micro-step 1 of 2, converted)."""
    root = tmp_path_factory.mktemp("qsm")
    write_qsm_dataset(root, grid=GRID)
    context = jqsm.get_context(variables={"DATASET_PATH": str(root)}, microbatch=2, **SMALL)
    # without dropout both packages take the same steps; the schedule's
    # sweeps and contour images are left out (steps only)
    context.update_component("model", dropout_p=0.0)
    context.update_component("trainer", training_evaluators=[], validation_evaluators=[],
                             scoring_function=None)
    context.init_components()
    jsp.seed_all(0)
    logger = JFileLogger(str(tmp_path_factory.mktemp("logs")))
    context.trainer.train(context, max_iterations=1, logger=logger)
    ckpt = sorted((logger.run_dir / "checkpoints").iterdir())[-1]
    [converted] = convert_jax_checkpoint(ckpt, tmp_path_factory.mktemp("torch") / ckpt.name)
    return root, ckpt, converted


def _loaded(pkg, path, root):
    kwargs = {"device": "cpu"} if pkg is tsp else {}
    context = pkg.Context(file_path=str(path), variables={"DATASET_PATH": str(root)}, **kwargs)
    context.init_components()
    return context


def test_converted_accumulation_state_matches_jax(checkpoint):
    """MultiStepsState -> the port's MultiSteps: mini_step 1, gradient_step
    0, the accumulated gradients exactly, no inner Adam step yet."""
    root, ckpt, converted = checkpoint
    with open(ckpt, "rb") as f:
        jdefs = {d["name"]: d for d in pickle.load(f)["component_definitions"]}
    jstate = jdefs["trainer"]["state_dict"]["opt_state"]
    assert type(jstate).__name__ == "MultiStepsState"
    context = _loaded(tsp, converted, root)
    optimizer = context.trainer._optimizer_for(context.model, context.optimizer)
    assert isinstance(optimizer, tsp.MultiSteps) and optimizer.every_k == 2
    assert (optimizer.mini_step, optimizer.gradient_step) == \
        (int(jstate.mini_step), int(jstate.gradient_step)) == (1, 0)
    assert not optimizer.optimizer.state
    ref = flax_to_state_dict({"params": jstate.acc_grads})
    names = list(context.model.params)
    assert len(names) == len(ref) == len(optimizer.acc_grads)
    for name, acc in zip(names, optimizer.acc_grads):
        assert torch.equal(acc, ref[name]), name
        assert acc.abs().max() > 0, name


def test_next_two_micro_steps_match_jax(checkpoint):
    root, ckpt, converted = checkpoint
    # JAX in one call of two micro-steps (one compile); the port in two
    # calls, read after each
    jctx = _loaded(jsp, ckpt, root)
    jsp.seed_all(7)
    jctx.trainer.train(jctx, max_iterations=2, logger=jsp.NonLogger())
    tctx = _loaded(tsp, converted, root)
    tsp.seed_all(7)
    params = []
    for _ in range(2):
        tctx.trainer.train(tctx, max_iterations=1, logger=tsp.NonLogger())
        params.append(_params(tsp, tctx))
        if len(params) == 1:
            grads = {k: p.grad.numpy().copy() for k, p in tctx.model.params.items()}
    assert tctx.trainer.iteration == jctx.trainer.iteration == 3
    # the second micro-step banks its gradients: nothing moves
    assert all(np.array_equal(params[0][k], params[1][k]) for k in params[0])
    # The update: Adam's first step is lr * g / (|g| + eps), about lr *
    # sign(g), with g the mean of the two micro-steps' gradients (the port
    # leaves it in .grad). Where 0 < |g| <= 1e-6, far below the gradient's
    # scale, rounding noise picks the sign; elsewhere the update is
    # determined and agrees to float32 rounding (as test_torch_train_step.py
    # holds one Adam step).
    ours, ref = params[1], _params(jsp, jctx)
    assert ours.keys() == ref.keys()
    undetermined = total = 0
    for name, g in grads.items():
        g = np.abs(g)
        determined = (g > 1e-6) | (g == 0)
        np.testing.assert_allclose(ours[name][determined], ref[name][determined], atol=1e-6,
                                   err_msg=name)
        assert np.abs(ours[name] - ref[name]).max() <= 2 * LR, name
        undetermined += int((~determined).sum())
        total += g.size
    assert undetermined < 0.01 * total


def test_mismatched_accumulation_raises(checkpoint):
    """A MultiStepsState beside an optimizer definition without
    accumulation (or the other way round) cannot be converted."""
    _, ckpt, _ = checkpoint
    checkpoint_data = pickle.loads(ckpt.read_bytes())
    optimizer = next(d for d in checkpoint_data["component_definitions"]
                     if d["name"] == "optimizer")
    optimizer["params"]["accumulate_steps"] = 1
    with pytest.raises(JaxCheckpointError, match="MultiStepsState"):
        convert_checkpoint_data(pickle.dumps(checkpoint_data))


def test_qsm_configuration_converts_with_the_port_attributes(checkpoint, tmp_path):
    """JAX's qsm configuration as it stands before training (its scoring
    function a closure, stored as cloudpickle bytes) converts; every object
    comes back with the attributes of the port's own configuration's object
    at the same place, and the scoring closure scores."""
    from test_torch_jax_checkpoint import _objects

    root = checkpoint[0]
    context = jqsm.get_context(variables={"DATASET_PATH": str(root)}, microbatch=2,
                               tpu_fast_path=True, compute_dtype="bfloat16", **SMALL)
    converted = convert_checkpoint_data(pickle.dumps(context.snapshot()))
    own = tqsm.get_context(device="cpu", variables={"DATASET_PATH": str(root)}, microbatch=2,
                           tpu_fast_path=True, compute_dtype="bfloat16", **SMALL)
    assert [d["name"] for d in converted["component_definitions"]] == \
        [d["name"] for d in own.component_definitions]
    for got, want in zip(converted["component_definitions"], own.component_definitions):
        assert got["constructor"] is want["constructor"], got["name"]
        objects = [{}, {}]
        for params, out in zip((got["params"], want["params"]), objects):
            _objects(params, got["name"], out)
        # the closure travels as cloudpickle bytes until the Context loads it
        payloads = [k for k, (cls, _) in objects[0].items() if cls == "_FunctionPayload"]
        assert payloads == (["trainer.scoring_function"] if got["name"] == "trainer" else [])
        for key in payloads:
            del objects[0][key]
        assert objects[0] == objects[1], got["name"]
    path = tmp_path / "qsm.ckpt"
    tsp.Context.write_snapshot(converted, path)
    loaded = tsp.Context("cpu", file_path=str(path), variables={"DATASET_PATH": str(root)})
    loaded.init_components()
    assert loaded.optimizer.accumulate_steps == 2 and loaded.trainer.device_cache
    stats = tsp.LabeledTensor(["stat", "class", "metric"], [["mean", "std"], ["a", "b"], ["dice"]])
    stats["mean", "a", "dice"], stats["mean", "b", "dice"] = 0.5, 0.7
    score = loaded.trainer.scoring_function(
        {"segmentation_eval": {"validation": {"summary_stats": stats}}})
    assert score == pytest.approx(0.6)
