"""The port's spatial sharding against the JAX package's, on the CPU.

The port's ranks are spawned gloo processes (tests/test_torch_spatial_ranks.py
holds their bodies and imports no JAX); the JAX side runs in this process on
the host devices of tests/conftest.py, on a mesh of as many devices as the
port has ranks. Both sides start from the same numpy inputs and the same
weights (JAX's initialisation, converted). Sizes and tolerances are
tests/test_parallel.py's:

- the halo exchange (each device's widened slab, exactly) and
  sharded_conv3d (16x8x8, 3 -> 5, atol 1e-4);
- the parameter gradients of a loss over the W-sharded NestedResUNet
  forward (1 -> 2, filters 4, 64x16x8, atol 1e-5), the input gradient too;
- upsample_trilinear2x_sharded;
- spatial_sharded_inference (2 -> 3, 64x16x8, atol 2e-5), with the plain
  version of the hand conv called once for each of the 25 convs, on the
  slab widened by its halo, and the misaligned-width error on both sides;
- sharded_volume_sliding_window with the network (64x16x16, patch 8,
  overlap 4) and in hann mode with a patch-dependent model (32x12x8, patch
  4, overlap 2), atol 1e-5, and PatchPredict(volume_sharded=True);
- make_spatial_train_step, 3 SGD steps at dropout 0, on a (2,) spatial
  mesh (W=32) and a (2, 2) data x spatial mesh (W=16): the loss within
  1e-6, the parameters and BatchNorm statistics within 2e-5;
- SegmentationTrainer(spatial_axis=) on a (2,) mesh, the setup of
  TestTrainerSpatialSharding with SGD from the same weights, 4
  iterations: the losses, the training Dice and the final state at the
  step's tolerances.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_tpu.criterions import HybridLogisticDiceLoss as JLoss
from segmentation_pipeline_tpu.models import NestedResUNet as JNestedResUNet
from segmentation_pipeline_tpu.ops import convolution as jconv
from segmentation_pipeline_tpu.ops.sliding_window import sliding_window_inference
from segmentation_pipeline_tpu.parallel import halo as jhalo
from segmentation_pipeline_tpu.parallel.sharded_model import spatial_sharded_inference
from segmentation_pipeline_tpu.training import optimizers as joptim
from segmentation_pipeline_tpu.training import train_step as jtrain
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
from test_torch_spatial_ranks import (SPATIAL_ITERATIONS, cases_ranks, spatial_context,
                                     spawn_ranks, step_spec, write_spatial_dataset)

torch.set_num_threads(2)


def jax_mesh(shape, names=("data",)):
    devices = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devices, names)


def jax_model(cin, cout, x):
    model = JSegModel(JNestedResUNet(input_channels=cin, output_channels=cout, filters=4))
    model.ensure_initialized(x)
    return model


def port_state(model):
    return {k: v.numpy() for k, v in tsp.flax_to_state_dict(model.variables).items()}


def flat_port(state):
    return flatten_dict(state_dict_to_flax({k: torch.from_numpy(v) for k, v in state.items()}))


def inputs():
    rng = np.random.default_rng(0)
    conv = (rng.normal(size=(16, 8, 8, 3)).astype(np.float32),
            rng.normal(size=(3, 3, 3, 3, 5)).astype(np.float32))
    grad_volume = rng.normal(size=(1, 1, 64, 16, 8)).astype(np.float32)
    forward_volume = rng.normal(size=(2, 64, 16, 8)).astype(np.float32)
    window_volume = rng.normal(size=(1, 64, 16, 16)).astype(np.float32)
    return dict(conv=conv, upsample=rng.normal(size=(2, 8, 6, 4, 3)).astype(np.float32),
                grad_volume=grad_volume, forward_volume=forward_volume,
                window_volume=window_volume,
                hann=rng.normal(size=(2, 32, 12, 8)).astype(np.float32),
                subject=rng.normal(size=(1, 64, 16, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks (every serving case and the (2,) spatial step)
    and one of 4 (the (2, 2) step), beside the JAX models they share."""
    data = inputs()
    grad_model = jax_model(1, 2, data["grad_volume"])
    forward_model = jax_model(2, 3, data["forward_volume"][None])
    target = np.zeros((1, 64, 16, 8, 2), np.float32)
    target[..., 1] = 1.0
    # the port's gradients are of a channels-last input and target
    grad_x = np.moveaxis(data["grad_volume"], 1, -1)
    serving = {"conv": data["conv"], "upsample": data["upsample"],
               "gradients": (port_state(grad_model), grad_x[0][None], target),
               "forward": (port_state(forward_model), data["forward_volume"]),
               "window": (port_state(grad_model), data["window_volume"]),
               "window_hann": data["hann"], "patch_predict": data["subject"]}
    spatial, both = step_spec(2, 32), step_spec(4, 16)
    for spec in (spatial, both):  # JAX's initialisation, as in the JAX package's test
        spec["jax"] = jax_model(1, 2, spec["batch"]["X"])
        spec["state"] = port_state(spec["jax"])
    trainer_root = tmp_path_factory.mktemp("spatial-trainer") / "data"
    write_spatial_dataset(trainer_root)
    two = spawn_ranks(cases_ranks, 2, tmp_path_factory.mktemp("spatial2"),
                      [("serving_ranks", (serving,)),
                       ("spatial_step_ranks", (dict(spatial, jax=None), ("spatial",), (2,),
                                               None)),
                       ("spatial_trainer_sgd_ranks", (str(trainer_root), spatial["state"],
                                                      spatial["lr"]))])
    four = spawn_ranks(cases_ranks, 4, tmp_path_factory.mktemp("spatial4"),
                       [("spatial_step_ranks", (dict(both, jax=None), ("data", "spatial"),
                                                (2, 2), "data"))])
    return dict(data=data, grad_model=grad_model, forward_model=forward_model, target=target,
                serving=[r[0] for r in two], spatial=(spatial, [r[1] for r in two]),
                trainer=(trainer_root, [r[2] for r in two]),
                both=(both, [r[0] for r in four]))


def test_halo_exchange_and_sharded_conv_match_jax(runs):
    x, kernel = runs["data"]["conv"]
    mesh = jax_mesh((2,))
    widened = shard_map(lambda t: jhalo.halo_exchange(t, 1, "data"), mesh=mesh,
                        in_specs=P("data"), out_specs=P("data"))(jnp.asarray(x))
    widened = np.asarray(widened).reshape(2, 10, *x.shape[1:])
    conv = np.asarray(jhalo.sharded_conv3d(jnp.asarray(x), jnp.asarray(kernel), mesh))
    for r, result in enumerate(runs["serving"]):
        ext, out = result["conv"]
        np.testing.assert_array_equal(ext, widened[r])
        np.testing.assert_allclose(out, conv[8 * r:8 * r + 8], atol=1e-4)


def test_gradients_through_the_halo_forward_match_jax(runs):
    """tests/test_parallel.py's TestSpatialShardedGradients: the port's
    W-sharded forward, its loss summed over the slabs; the parameter
    gradients summed over the ranks and each rank's input gradient
    against JAX's unsharded gradients."""
    model, target = runs["grad_model"], runs["target"]
    module, variables = model.module, model.variables
    x_cl = jnp.moveaxis(jnp.asarray(runs["data"]["grad_volume"]), 1, -1)

    def loss(params, x):
        y = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                         train=False)
        return ((y - target) ** 2).mean()

    value, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(variables["params"], x_cl)
    ref = flatten_dict(gp)
    gx = np.asarray(gx)[0]
    for r, result in enumerate(runs["serving"]):
        grads, dx, got = result["gradients"]
        np.testing.assert_allclose(got, float(value), rtol=1e-5)
        flat = flat_port({k: v for k, v in grads.items()})
        for key, want in ref.items():
            np.testing.assert_allclose(flat[("params",) + key], np.asarray(want), atol=1e-5,
                                       err_msg="/".join(key))
        np.testing.assert_allclose(dx[0], gx[32 * r:32 * r + 32], atol=1e-5)


def test_sharded_upsample_matches_jax(runs):
    x = runs["data"]["upsample"]
    mesh = jax_mesh((2,))
    ref = shard_map(lambda t: jconv.upsample_trilinear2x_sharded(t, "data"), mesh=mesh,
                    in_specs=P(None, "data"), out_specs=P(None, "data"))(jnp.asarray(x))
    ref = np.asarray(ref)
    assert np.allclose(ref, np.asarray(jconv.upsample_trilinear2x(jnp.asarray(x))), atol=1e-6)
    for r, result in enumerate(runs["serving"]):
        np.testing.assert_allclose(result["upsample"], ref[:, 8 * r:8 * r + 8], atol=1e-6)


def test_spatial_sharded_inference_matches_jax(runs):
    """Each rank's slab of the output is the slab of JAX's sharded forward
    (atol 2e-5); the port ran its 25 convs through the hand conv's plain
    version, each on its level's slab widened by two rows; both sides
    refuse W=24 at 2 ranks (24 % 16)."""
    volume = runs["data"]["forward_volume"]
    mesh = jax_mesh((2,))
    ref = np.asarray(spatial_sharded_inference(runs["forward_model"], volume, mesh))
    direct = np.asarray(runs["forward_model"](volume[None]))[0]
    np.testing.assert_allclose(ref, direct, atol=2e-5)
    widths = {32 + 2: 13, 16 + 2: 6, 8 + 2: 4, 4 + 2: 2}  # the slab per level, its convs
    for r, result in enumerate(runs["serving"]):
        out, shapes = result["forward"]
        np.testing.assert_allclose(out, ref[:, 32 * r:32 * r + 32], atol=2e-5)
        assert len(shapes) == 25
        assert {w: sum(s[1] == w for s in shapes) for w in widths} == widths
    with pytest.raises(ValueError, match="must be divisible by mesh_size"):
        spatial_sharded_inference(runs["forward_model"],
                                  np.zeros((2, 24, 16, 8), np.float32), mesh)


def test_sharded_volume_window_and_patch_predict_match_jax(runs):
    model = runs["grad_model"]
    mesh = jax_mesh((2,))
    module, variables = model.module, model.variables

    def model_fn(p):
        return module.apply(variables, p, train=False)

    volume = runs["data"]["window_volume"]
    ref = np.asarray(jhalo.sharded_volume_sliding_window(volume, model_fn, 8, 4, mesh=mesh))
    single = np.asarray(sliding_window_inference(volume, model_fn, 8, 4, patch_batch=1))
    np.testing.assert_allclose(ref, single, atol=1e-5)

    def patch_dependent(p):
        return p + jnp.mean(p, axis=(1, 2, 3, 4), keepdims=True)

    hann = runs["data"]["hann"]
    ref_hann = np.asarray(jhalo.sharded_volume_sliding_window(hann, patch_dependent, 4, 2,
                                                              mode="hann", mesh=mesh))

    def threshold(x):
        fg = (jnp.asarray(x)[:, 0:1] > 0).astype(jnp.float32)
        return jnp.concatenate([1 - fg, fg], axis=1)

    subject = jsp.Subject({"X": jsp.ScalarImage(tensor=runs["data"]["subject"],
                                                affine=np.eye(4))})
    [served], _ = jsp.PatchPredict(image_names=["X"], patch_size=8, patch_overlap=4,
                                   mesh=mesh, volume_sharded=True).predict(
        threshold, [copy.deepcopy(subject)])
    ref_pp = np.asarray(served["y_pred"].data)
    for r, result in enumerate(runs["serving"]):
        np.testing.assert_allclose(result["window"], ref[:, 32 * r:32 * r + 32], atol=1e-5)
        np.testing.assert_allclose(result["window_hann"], ref_hann[:, 16 * r:16 * r + 16],
                                   atol=1e-5)
        np.testing.assert_allclose(result["patch_predict"], ref_pp, atol=1e-5)


def jax_spatial_steps(spec, mesh, data_axis):
    model = spec["jax"]
    optimizer = joptim.SGD(lr=spec["lr"])
    state = jtrain.create_train_state(model, optimizer, spec["batch"])
    state = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), state)
    step = jtrain.make_spatial_train_step(model.module, JLoss(), optimizer, mesh,
                                          spatial_axis="spatial", data_axis=data_axis)
    batch = {k: jnp.moveaxis(jnp.asarray(v), 1, -1) for k, v in spec["batch"].items()}
    losses = []
    for i in range(spec["steps"]):
        state, loss_dict, _ = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss_dict["loss"]))
    tree = {"params": state.params, "batch_stats": state.batch_stats}
    return losses, flatten_dict(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("case", ["spatial", "both"], ids=["spatial-2", "data2-x-spatial2"])
def test_spatial_train_step_matches_jax(runs, case):
    spec, ranks = runs[case]
    mesh = jax_mesh((2,), ("spatial",)) if case == "spatial" else \
        jax_mesh((2, 2), ("data", "spatial"))
    losses, ref = jax_spatial_steps(spec, mesh, None if case == "spatial" else "data")
    for result in ranks:
        np.testing.assert_allclose([l["loss"] for l in result["losses"]], losses, atol=1e-6)
        flat = flat_port(result["state"])
        assert flat.keys() == ref.keys()
        for key, want in ref.items():
            np.testing.assert_allclose(flat[key], want, atol=2e-5, err_msg="/".join(key))


class JaxRecordingLogger(jsp.NonLogger):
    def __init__(self):
        self.records = []

    def log(self, log_dict):
        self.records.append(log_dict)


def test_spatial_trainer_matches_jax_trainer(runs):
    """SegmentationTrainer(spatial_axis="spatial") on a (2,) mesh against
    the JAX trainer on a (2,) mesh of host devices: the setup of the JAX
    package's TestTrainerSpatialSharding (batch 2 of 32 x 16 x 8, its
    scheduled training Dice on the prediction gathered from the slabs)
    with SGD from the same weights, 4 iterations. Rank 0's losses within
    1e-6, the Dice within 1e-6, both ranks' weights and BatchNorm
    statistics within 2e-5, and the change of the weights over the run
    within 1e-3 of JAX's, relative (a gradient off by a factor would show
    there)."""
    root, ranks = runs["trainer"]
    spatial, _ = runs["spatial"]
    context = spatial_context(jsp, root, jax_mesh((2,), ("spatial",)), "spatial",
                              ("SGD", spatial["lr"]))
    context.init_components()
    start = {k: torch.from_numpy(v) for k, v in spatial["state"].items()}
    context.model.load_state_dict(state_dict_to_flax(start))
    jsp.seed_all(0)
    logger = JaxRecordingLogger()
    context.trainer.train(context, max_iterations=SPATIAL_ITERATIONS, logger=logger)
    losses = {r["iteration"]: r["loss"] for r in logger.records if "loss" in r}
    dices = {r["iteration"]: float(r["seg"]["summary_stats"]["mean", "fg", "dice"])
             for r in logger.records if "seg" in r}
    ref = flatten_dict(jax.tree_util.tree_map(np.asarray, dict(context.model.variables)))
    first = flat_port(spatial["state"])
    assert sorted(losses) == list(range(SPATIAL_ITERATIONS)) and sorted(dices) == [0, 2]
    assert sorted(ranks[0]["losses"]) == sorted(losses) and ranks[1]["losses"] == {}
    for it, loss in losses.items():
        np.testing.assert_allclose(ranks[0]["losses"][it], loss, atol=1e-6)
    for it, dice in dices.items():
        np.testing.assert_allclose(ranks[0]["dices"][it], dice, atol=1e-6)
    for result in ranks:
        flat = flat_port(result["state"])
        assert flat.keys() == ref.keys()
        for key, want in ref.items():
            np.testing.assert_allclose(flat[key], want, atol=2e-5, err_msg="/".join(key))
        moved = np.concatenate([(flat[k] - first[k]).ravel() for k in ref if k[0] == "params"])
        want = np.concatenate([(ref[k] - first[k]).ravel() for k in ref if k[0] == "params"])
        assert np.linalg.norm(want) > 0
        assert np.linalg.norm(moved - want) <= 1e-3 * np.linalg.norm(want)
