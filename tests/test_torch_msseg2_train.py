"""msseg2's train step in the port against the JAX package's
``make_train_step``, on the CPU: msseg2's network
(research/msseg2/msseg2.py:163-178: ModularUNet with residual blocks,
BlurConv3d down, BlurConvTranspose3d up and rematerialized blocks) at filters
(4, 4, 8), depth 3, with its SGD(lr=0.001, momentum=0.95) and
HybridLogisticDiceLoss(logistic_class_weights=[1, 100]), on one numpy batch
of 2 patches of 2x16^3 and the same weights (converted from the port's
random state dict). Then the port's remat against no remat, bit for bit,
dropout included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import chip_smoke
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_tpu.criterions import HybridLogisticDiceLoss as JLoss
from segmentation_pipeline_tpu.training import optimizers as joptim
from segmentation_pipeline_tpu.training import train_step as jtrain
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_torch.ops import conv3x3
from test_torch_patch_predict import msseg2_pair

torch.set_num_threads(2)

FILTERS = (4, 4, 8)
SGD_KWARGS = {"lr": 0.001, "momentum": 0.95}
CLASS_WEIGHTS = [1, 100]
STEPS = 3


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, 2, 16, 16, 16)).astype(np.float32)
    lesion = (X[:, 1] > 1.2).astype(np.float32)
    return {"X": X, "y": np.stack([1 - lesion, lesion], axis=1)}


def _run_jax(jmodel, steps, compute_dtype=None):
    optimizer = joptim.SGD(**SGD_KWARGS)
    batch_cf = _batch()
    state = jtrain.create_train_state(jmodel, optimizer, batch_cf)
    step = jtrain.make_train_step(jmodel.module, JLoss(logistic_class_weights=CLASS_WEIGHTS),
                                  optimizer, compute_dtype=compute_dtype)
    batch = jtrain.collate_to_device(batch_cf)
    grads = None
    if compute_dtype is None:
        # the first step's gradients, as the step's own loss_fn takes them
        def loss(params):
            y_pred, _ = jmodel.module.apply(
                {"params": params, "batch_stats": state.batch_stats}, batch["X"], train=True,
                rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            return JLoss(logistic_class_weights=CLASS_WEIGHTS)(
                y_pred.astype(jnp.float32), batch["y"])["loss"]
        grads = flatten_dict(jax.tree_util.tree_map(np.asarray,
                                                    jax.jit(jax.grad(loss))(state.params)))
    losses = []
    for i in range(steps):
        state, loss_dict, _ = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss_dict["loss"]))
    stats = flatten_dict(jax.tree_util.tree_map(np.asarray, {"batch_stats": state.batch_stats}))
    return losses, grads, stats


def _run_port(model, steps, compute_dtype=None, generator=None):
    """Losses, the first step's gradients by state-dict name and the state
    dict after the steps."""
    optimizer = tsp.SGD(**SGD_KWARGS)
    batch_cf = _batch()
    state = tsp.create_train_state(model, optimizer, batch_cf)
    step = tsp.make_train_step(model.module, tsp.HybridLogisticDiceLoss(
        logistic_class_weights=CLASS_WEIGHTS), optimizer, compute_dtype=compute_dtype)
    batch = tsp.collate_to_device(batch_cf, device="cpu")
    losses, grads = [], None
    for _ in range(steps):
        state, loss_dict, y_pred = step(state, batch, generator)
        losses.append(loss_dict["loss"].item())
        if grads is None:
            grads = {k: p.grad.clone() for k, p in state.params.items()}
    assert state.step == steps and y_pred.dtype == torch.float32
    return losses, grads, {k: v.clone() for k, v in model.module.state_dict().items()}


@pytest.fixture(scope="module")
def f32_runs():
    jmodel, model = msseg2_pair(FILTERS, 5)
    return _run_jax(jmodel, STEPS), _run_port(model, STEPS)


def test_losses_over_three_steps_match_jax(f32_runs):
    (ref_losses, _, _), (losses, _, _) = f32_runs
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] != losses[0]


def test_first_step_gradients_match_jax(f32_runs):
    """Each leaf's gradient within 1e-4 of its max|g| (f32 sums in another
    order through 16 convs and 10 BatchNorms, forward and backward); the
    parameter updates are not compared: at lr 1e-3 they are ~1e-6 on
    weights of ~0.1, where f32 cancellation in p1 - p0 dominates."""
    (_, ref, _), (_, grads, _) = f32_runs
    got = flatten_dict(state_dict_to_flax(grads)["params"])
    assert set(got) == set(ref)
    for key, g in got.items():
        r = ref[key]
        assert g.shape == r.shape
        scale = float(np.abs(r).max())
        assert scale > 0, key
        np.testing.assert_allclose(g, r, atol=1e-4 * scale, rtol=0, err_msg="/".join(key))


def test_running_statistics_match_jax(f32_runs):
    (_, _, ref), (_, _, state) = f32_runs
    got = flatten_dict(state_dict_to_flax(state))
    stats = {k: v for k, v in got.items() if k[0] == "batch_stats"}
    assert set(stats) == set(ref)
    for key in ref:
        np.testing.assert_allclose(stats[key], ref[key], atol=1e-6, rtol=1e-5,
                                   err_msg="/".join(key))
    assert all(int(v) == STEPS for k, v in state.items() if k.endswith("num_batches_tracked"))


def _model(remat, dropout_p):
    module = tsp.ModularUNet(2, 2, filters=list(FILTERS), depth=len(FILTERS),
                             block_params={"residual": True, "dropout_p": dropout_p},
                             downsample_class=tsp.BlurConv3d,
                             upsample_class=tsp.BlurConvTranspose3d, remat=remat)
    model = tsp.SegModel(module, device="cpu")
    model.load_state_dict(chip_smoke.msseg2_state(np.random.default_rng(9), module))
    return model


@pytest.mark.parametrize("dropout_p", [0.0, 0.25])
def test_remat_equals_no_remat_bit_for_bit(monkeypatch, dropout_p):
    """Loss, gradients, running statistics (moved once a step) and the
    dropout generator's final state are the same bits with and without
    rematerialized blocks; with remat the 15 convs inside the blocks run
    their forward again in the backward (31 forward calls a step, not 16)."""
    calls = []
    forward = conv3x3.conv3x3_s1p1
    monkeypatch.setattr(conv3x3, "conv3x3_s1p1",
                        lambda x, k: (calls.append(1), forward(x, k))[1])
    out = {}
    for remat in (False, True):
        calls.clear()
        generator = torch.Generator().manual_seed(1)
        losses, grads, state = _run_port(_model(remat, dropout_p), 2, generator=generator)
        out[remat] = losses, grads, state, generator.get_state(), len(calls)
    (l0, g0, s0, r0, n0), (l1, g1, s1, r1, n1) = out[False], out[True]
    assert (n0, n1) == (2 * 16, 2 * 31)
    assert l0 == l1
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(int(v) == 2 for k, v in s1.items() if k.endswith("num_batches_tracked"))
    assert torch.equal(r0, r1)
    if dropout_p:
        assert not torch.equal(r1, torch.Generator().manual_seed(1).get_state())


def test_remat_changes_nothing_without_autograd():
    """Eval mode, and train mode under no_grad, run the blocks plainly: the
    same outputs with and without remat."""
    x = torch.from_numpy(_batch()["X"]).permute(0, 2, 3, 4, 1).contiguous()
    a, b = _model(False, 0.0).module, _model(True, 0.0).module
    for mode in ("eval", "train"):
        getattr(a, mode)(), getattr(b, mode)()
        with torch.no_grad():
            assert torch.equal(a(x), b(x))


def test_one_bf16_step_loss_matches_jax():
    """bf16 activations and convs over f32 state: the frameworks round to 8
    bits at other places, so the loss agrees to 1e-3 relative."""
    jmodel, model = msseg2_pair(FILTERS, 5)
    ref_losses, _, _ = _run_jax(jmodel, 1, compute_dtype="bfloat16")
    losses, grads, _ = _run_port(model, 1, compute_dtype="bfloat16")
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
