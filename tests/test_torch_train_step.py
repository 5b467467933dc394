"""The port's train step against the JAX package's ``make_train_step``: the
same NestedResUNet weights (converted from the flax tree), the same numpy
batch of 2 subjects of 3x16x16x8 through the sagittal split, dropout 0, on
the CPU (the port's conv Function runs its plain versions here)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import segmentation_pipeline_torch as tsp
from segmentation_pipeline_tpu.criterions import HybridLogisticDiceLoss as JLoss
from segmentation_pipeline_tpu.models import NestedResUNet as JNestedResUNet
from segmentation_pipeline_tpu.training import optimizers as joptim
from segmentation_pipeline_tpu.training import train_step as jtrain
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_torch.training.train_step import (apply_stochastic_matrix_cl,
                                                              reverse_split_and_flip_cl,
                                                              split_and_flip_cl)

torch.set_num_threads(2)

SGD_KWARGS = {"lr": 0.01, "momentum": 0.9}
ADAM_LR = 2e-4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 3, 16, 16, 8)).astype(np.float32)
    lab = (X[:, 0] > 0.5).astype(np.float32)
    batch_cf = {"X": X, "y": np.stack([1 - lab, lab], axis=1)}
    jnet = JNestedResUNet(input_channels=3, output_channels=2, filters=8, dropout_p=0.0)
    init = jax.jit(functools.partial(jnet.init, train=False))
    variables = init({"params": jax.random.PRNGKey(0)}, jnp.asarray(np.moveaxis(X, 1, -1)))
    return jnet, jax.tree_util.tree_map(np.asarray, variables), batch_cf


def _run_jax(setup, optimizer, steps, compute_dtype=None):
    jnet, variables, batch_cf = setup
    model = JSegModel(jnet)
    model.load_state_dict(variables)
    state = jtrain.create_train_state(model, optimizer, batch_cf)
    step = jtrain.make_train_step(jnet, JLoss(), optimizer, sagittal_split=True,
                                  compute_dtype=compute_dtype)
    batch = jtrain.collate_to_device(batch_cf)
    losses = []
    for i in range(steps):
        state, loss_dict, y_pred = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss_dict["loss"]))
    tree = {"params": state.params, "batch_stats": state.batch_stats}
    return losses, flatten_dict(jax.tree_util.tree_map(np.asarray, tree)), np.asarray(y_pred)


def _run_port(setup, optimizer, steps, compute_dtype=None):
    _, variables, batch_cf = setup
    model = tsp.SegModel(tsp.NestedResUNet(3, 2, filters=8), device="cpu")
    model.load_state_dict(tsp.flax_to_state_dict(variables))
    state = tsp.create_train_state(model, optimizer, batch_cf)
    step = tsp.make_train_step(model.module, tsp.HybridLogisticDiceLoss(), optimizer,
                               sagittal_split=True, compute_dtype=compute_dtype)
    batch = tsp.collate_to_device(batch_cf, device="cpu")
    losses = []
    for _ in range(steps):
        state, loss_dict, y_pred = step(state, batch, None)
        losses.append(loss_dict["loss"].item())
    assert state.step == steps and y_pred.dtype == torch.float32
    return losses, model, state, y_pred.numpy()


def _leaves(model):
    return flatten_dict(state_dict_to_flax(model.module.state_dict()))


@pytest.fixture(scope="module")
def sgd_runs(setup):
    return (_run_jax(setup, joptim.SGD(**SGD_KWARGS), 5),
            _run_port(setup, tsp.SGD(**SGD_KWARGS), 5))


def test_five_sgd_steps_match_jax(setup, sgd_runs):
    (ref_losses, ref, ref_pred), (losses, model, state, y_pred) = sgd_runs
    # f32 through 25 convs and 20 BatchNorms, forward and backward, in
    # another summation order: parameters differ by ~2e-6. The train-mode
    # prediction normalizes the deepest level by the statistics of 8 voxels
    # per channel, which magnifies that to ~4e-5.
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(y_pred, ref_pred, atol=1e-4)
    out, init = _leaves(model), flatten_dict(setup[1])
    assert out.keys() == ref.keys()
    for key in ref:
        assert not np.array_equal(ref[key], init[key]), key  # every leaf moved
        np.testing.assert_allclose(out[key], ref[key], atol=2e-5, rtol=1e-4,
                                   err_msg="/".join(key))
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in state.params.values())


def test_one_adam_step_matches_jax(setup):
    ref_losses, ref, _ = _run_jax(setup, joptim.Adam(lr=ADAM_LR), 1)
    losses, model, state, _ = _run_port(setup, tsp.Adam(lr=ADAM_LR), 1)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    out = _leaves(model)
    grads = flatten_dict(state_dict_to_flax({k: p.grad for k, p in state.params.items()}))
    undetermined = total = 0
    for key in ref:
        if key[0] == "batch_stats":
            np.testing.assert_allclose(out[key], ref[key], atol=1e-6, rtol=1e-5)
            continue
        # Adam's first step is lr * g / (|g| + eps), about lr * sign(g): where
        # 0 < |g| is far below the gradient's scale (1e-6 here, against
        # medians of ~1e-3), rounding noise picks the sign; elsewhere the
        # update is determined (0 where g is 0: taps that read only padding)
        # and agrees to f32 rounding
        g = np.abs(grads[key])
        determined = (g > 1e-6) | (g == 0)
        np.testing.assert_allclose(out[key][determined], ref[key][determined], atol=1e-6,
                                   err_msg="/".join(key))
        assert np.abs(out[key] - ref[key]).max() <= 2 * ADAM_LR
        undetermined += int((~determined).sum())
        total += g.size
    assert undetermined < 0.01 * total


def test_one_bf16_step_loss_matches_jax(setup):
    """bf16 activations and convs over f32 state: the two frameworks round
    to 8 bits at other places, so the loss agrees to 1e-3 relative (the f32
    steps agree to 1e-6)."""
    ref_losses, _, _ = _run_jax(setup, joptim.SGD(**SGD_KWARGS), 1, compute_dtype="bfloat16")
    losses, model, state, _ = _run_port(setup, tsp.SGD(**SGD_KWARGS), 1,
                                        compute_dtype="bfloat16")
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in state.params.values())
    assert all(b.dtype == torch.float32 for b in state.batch_stats.values())


def test_eval_after_training_matches_jax(setup, sgd_runs):
    """SegModel serves the trained module: its eval-mode output equals the
    JAX SegModel's with the JAX step's updated variables."""
    jnet, _, batch_cf = setup
    (_, ref, _), (_, model, _, _) = sgd_runs
    jmodel = JSegModel(jnet)
    jmodel.load_state_dict(unflatten_dict(ref))
    out = model(batch_cf["X"])
    assert not model.module.training
    # eval-mode BatchNorm with the running statistics: f32 rounding only
    np.testing.assert_allclose(out.numpy(), np.asarray(jmodel(batch_cf["X"])), atol=1e-4)


def test_split_flip_and_cascade_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 6, 3, 2, 4)).astype(np.float32)
    split = split_and_flip_cl(torch.from_numpy(x))
    np.testing.assert_array_equal(split.numpy(),
                                  np.asarray(jtrain._split_and_flip_cl(jnp.asarray(x))))
    assert torch.equal(reverse_split_and_flip_cl(split), torch.from_numpy(x))
    prior = np.random.default_rng(4).uniform(size=(2, 6, 3, 2, 2)).astype(np.float32)
    ref = jtrain._apply_stochastic_matrix_cl(jnp.asarray(x), jnp.asarray(prior))
    out = apply_stochastic_matrix_cl(torch.from_numpy(x), torch.from_numpy(prior))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_collate_to_device_keeps_dtypes_and_moves_channels_last():
    batch = {"X": np.zeros((2, 3, 4, 5, 6)), "y": np.zeros((2, 4, 5, 6), np.uint8),
             "w": np.ones((2, 3, 4, 5, 6), np.float32)}
    ref = jtrain.collate_to_device(batch)
    out = tsp.collate_to_device(batch, device="cpu")
    for key in batch:
        assert tuple(out[key].shape) == ref[key].shape, key
        assert str(out[key].dtype).split(".")[-1] == str(ref[key].dtype), key
        assert out[key].is_contiguous()
