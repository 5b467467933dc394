"""The port's spatial sharding against its own one-device runs, on the CPU,
with the ranks as spawned gloo processes; and the rank bodies that
tests/test_torch_spatial.py holds against the JAX package.

This file imports no JAX: a spawned rank imports it by name to find its
body. Ranks start through ``test_torch_mesh_ranks.spawn_ranks`` (a
rendezvous file under the test's tmp_path, timeouts on the group and on
every join). A W-sharded tensor is, on each rank, its slab
(``Mesh.w_slab``); the bodies take the whole numpy arrays, slice their
slabs and return their slabs.

Cases here: the spatial step at dropout 0.2 on a (2,) spatial mesh and on
a (2, 2) data x spatial mesh against the one-device step (each rank's
masks are the one-device masks at its rows, the same on a sample's slabs;
the loss and the weights); the data-parallel step on a (2, 2) data x
model mesh, whose model axis holds replicas; the trainer with ``spatial_axis`` on 2 ranks
against the one-device trainer; a halo exchange's values, gradient and
traffic at 3 ranks.
"""
from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.models import components
from segmentation_pipeline_torch.ops import conv3x3
from segmentation_pipeline_torch.parallel import halo as thalo
from segmentation_pipeline_torch.parallel import mesh as tmesh
from test_torch_mesh_ranks import recorded_dropout, run_step, spawn_ranks, split_rows
from test_torch_mesh_ranks import step_spec as mesh_step_spec

torch.set_num_threads(1)


def slab(array, mesh, axis, dim):
    """This rank's slab of ``array`` along ``dim`` (sharded over ``axis``)."""
    index = [slice(None)] * array.ndim
    index[dim] = mesh.w_slab(array.shape[dim], axis)
    return np.ascontiguousarray(array[tuple(index)])


def port_model(state, cin, cout, filters=4, dropout=0.0):
    model = tsp.SegModel(tsp.NestedResUNet(cin, cout, filters=filters, dropout_p=dropout),
                         device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def random_state(cin, cout, filters=4, seed=0):
    """A NestedResUNet's weights in the port's layout, drawn from a seed,
    with non-trivial BatchNorm statistics."""
    torch.manual_seed(seed)
    module = tsp.NestedResUNet(cin, cout, filters=filters)
    state = {k: v.numpy().copy() for k, v in module.state_dict().items()}
    rng = np.random.default_rng(seed)
    for key in state:
        if key.endswith("running_mean"):
            state[key] = rng.normal(0, 0.1, state[key].shape).astype(np.float32)
        elif key.endswith("running_var"):
            state[key] = rng.uniform(0.5, 1.5, state[key].shape).astype(np.float32)
    return state


@contextlib.contextmanager
def counted_plain_convs(shapes):
    """Every call of the forward kernel's plain version records its input
    shape (the CPU path of ops/conv3x3.py::conv3x3_s1p1)."""
    original = conv3x3.conv3x3_s1p1_plain

    def counting(x, kernel):
        shapes.append(tuple(x.shape))
        return original(x, kernel)

    conv3x3.conv3x3_s1p1_plain = counting
    try:
        yield
    finally:
        conv3x3.conv3x3_s1p1_plain = original


# ---- rank bodies -----------------------------------------------------------

def halo_ranks(rank, world, x, kernel, g):
    """The halo exchange of 2 rows along W (dim 0) of x's slab, its
    gradient for the cotangent g's slab of the widened tensor, and the
    sharded conv of the slab, with the traffic counted."""
    mesh = tsp.make_mesh(device="cpu")
    thalo.TRAFFIC.clear()
    xs = torch.from_numpy(slab(x, mesh, "data", 0)).requires_grad_(True)
    ext = thalo.halo_exchange(xs, 2, mesh, "data", axis=0)
    w = xs.shape[0]
    g_ext = torch.from_numpy(g[rank * w:rank * w + w + 4])
    (ext * g_ext).sum().backward()
    with torch.no_grad():
        conv = thalo.sharded_conv3d(torch.from_numpy(slab(x, mesh, "data", 0)),
                                    torch.from_numpy(kernel), mesh)
    return dict(ext=ext.detach().numpy(), dx=xs.grad.numpy(), conv=conv.numpy(),
                traffic=dict(thalo.TRAFFIC))


def serving_ranks(rank, world, inputs):
    """The spatial serving paths on a 1-D 'data' mesh over the ranks,
    each where ``inputs`` asks for it: the halo exchange and the sharded
    conv, the sharded upsample, the network's
    gradients through the halo forward (eval mode), spatial_sharded_inference
    with the plain conv calls counted and its misaligned-width error, the
    W-sharded sliding window in average and hann modes, and
    PatchPredict(volume_sharded=True)."""
    mesh = tsp.make_mesh(device="cpu")
    out = {}
    if "conv" in inputs:
        x, kernel = inputs["conv"]
        xs = torch.from_numpy(slab(x, mesh, "data", 0))
        with torch.no_grad():
            out["conv"] = (thalo.halo_exchange(xs, 1, mesh, "data").numpy(),
                           thalo.sharded_conv3d(xs, torch.from_numpy(kernel), mesh).numpy())
    if "upsample" in inputs:
        x = torch.from_numpy(slab(inputs["upsample"], mesh, "data", 1))
        out["upsample"] = tsp.ops.convolution.upsample_trilinear2x_sharded(
            x, mesh, "data").numpy()
    if "gradients" in inputs:
        state, volume, target = inputs["gradients"]
        model = port_model(state, 1, 2)
        module = model.module.eval()
        x = torch.from_numpy(slab(volume, mesh, "data", 1)).requires_grad_(True)
        t = torch.from_numpy(slab(target, mesh, "data", 1))
        with components.spatially_sharded(module, mesh, "data"):
            y = module(x)
            loss = tmesh.all_reduce_sum(((y - t) ** 2).sum(), mesh) / target.size
            (loss / mesh.size).backward()
        tmesh.all_reduce_gradients(list(module.parameters()), mesh)
        out["gradients"] = ({k: p.grad.numpy().copy() for k, p in module.named_parameters()},
                            x.grad.numpy(), loss.item())
    if "forward" in inputs:
        state, volume = inputs["forward"]
        model = port_model(state, volume.shape[0], 3)
        shapes = []
        with counted_plain_convs(shapes):
            y = tsp.parallel.spatial_sharded_inference(
                model, slab(volume, mesh, "data", 1), mesh)
        out["forward"] = (y.numpy(), shapes)
        misaligned = np.zeros((volume.shape[0], 24 * world // 2, 16, 8), np.float32)
        with pytest.raises(ValueError, match="must be divisible by mesh_size"):
            tsp.parallel.spatial_sharded_inference(
                model, slab(misaligned, mesh, "data", 1), mesh)
    if "window" in inputs:
        state, volume = inputs["window"]
        module = port_model(state, 1, 2).module.eval()
        out["window"] = tsp.parallel.sharded_volume_sliding_window(
            torch.from_numpy(slab(volume, mesh, "data", 1)), lambda p: module(p), 8, 4,
            mesh=mesh, patch_batch=3).numpy()
    if "window_hann" in inputs:
        out["window_hann"] = tsp.parallel.sharded_volume_sliding_window(
            torch.from_numpy(slab(inputs["window_hann"], mesh, "data", 1)),
            lambda p: p + p.mean(dim=(1, 2, 3, 4), keepdim=True), 4, 2, mode="hann",
            mesh=mesh).numpy()
    if "patch_predict" in inputs:
        volume = inputs["patch_predict"]

        def threshold(x):
            fg = (x[:, 0:1] > 0).float()
            return torch.cat([1 - fg, fg], dim=1)

        predictor = tsp.PatchPredict(image_names=["X"], patch_size=8, patch_overlap=4,
                                     patch_batch_size=1, mesh=mesh, volume_sharded=True,
                                     device="cpu")
        subject = tsp.Subject({"X": tsp.ScalarImage(tensor=volume, affine=np.eye(4))})
        [served], _ = predictor.predict(threshold, [subject])
        out["patch_predict"] = np.asarray(served["y_pred"].data)
    return out


def step_spec(n, W, dropout=0.0, steps=3, seed=0, lr=1e-2):
    """tests/test_parallel.py's TestSpatialShardedTraining setup: a
    NestedResUNet(1 -> 2, filters 4) and a batch of ``n`` volumes of
    W x 16 x 8 with labels of density 0.3."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 1, W, 16, 8)).astype(np.float32)
    lab = (rng.random((n, W, 16, 8)) < 0.3).astype(np.float32)
    return dict(state=random_state(1, 2, seed=seed), batch={"X": X, "y": np.stack([1 - lab, lab], 1)},
                dropout=dropout, steps=steps, lr=lr)


def run_spatial_step(spec, mesh=None, spatial_axis="spatial", data_axis=None):
    """``spec["steps"]`` SGD steps of the spatial step on ``mesh`` (None:
    the one-device make_train_step), generator seed 7: the losses, the
    final state, the last prediction (this rank's part) and the dropout
    masks."""
    model = port_model(spec["state"], 1, 2, dropout=spec["dropout"])
    optimizer = tsp.SGD(lr=spec["lr"])
    state = tsp.create_train_state(model, optimizer, spec["batch"])
    if mesh is None:
        step = tsp.make_train_step(model.module, tsp.HybridLogisticDiceLoss(), optimizer)
        batch = tsp.collate_to_device(spec["batch"], device="cpu")
    else:
        step = tsp.make_spatial_train_step(model.module, tsp.HybridLogisticDiceLoss(),
                                           optimizer, mesh, spatial_axis, data_axis)
        batch = tsp.collate_to_device(spec["batch"], mesh=mesh, data_axis=data_axis,
                                      spatial_axis=spatial_axis)
    generator = torch.Generator().manual_seed(7)
    losses, masks = [], []
    thalo.TRAFFIC.clear()
    with recorded_dropout(masks):
        for _ in range(spec["steps"]):
            state, loss_dict, y_pred = step(state, batch, generator)
            losses.append({k: v.item() for k, v in loss_dict.items()})
    return dict(losses=losses, masks=masks, y_pred=y_pred.numpy(),
                traffic=dict(thalo.TRAFFIC),
                state={k: v.numpy().copy() for k, v in model.module.state_dict().items()})


def spatial_step_ranks(rank, world, spec, axis_names, shape, data_axis):
    mesh = tsp.make_mesh(world, axis_names, shape, device="cpu")
    return run_spatial_step(spec, mesh, "spatial", data_axis)


def write_spatial_dataset(root):
    """tests/test_parallel.py's TestTrainerSpatialSharding subjects: two
    32 x 16 x 8 volumes with a bright box as the foreground."""
    rng = np.random.default_rng(0)
    for i in range(2):
        d = root / "subjects" / f"s{i}"
        d.mkdir(parents=True)
        img = rng.normal(scale=0.3, size=(1, 32, 16, 8)).astype(np.float32)
        seg = np.zeros((1, 32, 16, 8), np.int16)
        seg[:, 8:24, 4:12, 2:6] = 1
        img[seg.astype(bool)] += 2.0
        tsp.write_nifti(d / "t1.nii.gz", img, np.eye(4))
        tsp.write_nifti(d / "seg.nii.gz", seg, np.eye(4))
        (d / "attributes.json").write_text(json.dumps({"fold": 0}))


def spatial_context(pkg, root, mesh, spatial_axis, optimizer=("Adam", 3e-3), **extra):
    """The setup of tests/test_parallel.py's TestTrainerSpatialSharding in
    ``pkg`` (the JAX package or the port), with ``optimizer`` (its name in
    ``pkg`` and its learning rate)."""
    loader = pkg.ComposeLoaders([
        pkg.ImageLoader(glob_pattern="t1.*", image_name="t1", image_constructor=pkg.ScalarImage),
        pkg.ImageLoader(glob_pattern="seg.*", image_name="seg", image_constructor=pkg.LabelMap,
                        label_values={"fg": 1}),
        pkg.AttributeLoader(glob_pattern="attributes.*"),
    ])
    transforms = {"default": pkg.Compose([
        pkg.ConcatenateImages(image_names=["t1"], image_channels=[1], new_image_name="X"),
        pkg.RenameProperty(old_name="seg", new_name="y"),
        pkg.CustomOneHot(include=["y"]),
    ])}
    device = {} if pkg.__name__ == "segmentation_pipeline_tpu" else {"device": "cpu"}
    context = pkg.Context(name="sp-shard", variables={"P": str(root)}, **device)
    context.add_component("dataset", pkg.SubjectFolder, root="$P", subject_path="subjects",
                          subject_loader=loader,
                          cohorts={"training": pkg.RequireAttributes(["t1"])},
                          transforms=transforms)
    context.add_component("model", pkg.NestedResUNet, input_channels=1, output_channels=2,
                          filters=4)
    context.add_component("optimizer", getattr(pkg, optimizer[0]), lr=optimizer[1])
    context.add_component("criterion", pkg.HybridLogisticDiceLoss)
    context.add_component(
        "trainer", pkg.SegmentationTrainer,
        training_batch_size=2, save_rate=100, scoring_interval=100,
        scoring_function=lambda d: 0.0, one_time_evaluators=[],
        training_evaluators=[pkg.ScheduledEvaluation(
            evaluator=pkg.SegmentationEvaluator("y_pred_eval", "y_eval"), log_name="seg",
            interval=2)],
        validation_evaluators=[], max_iterations_with_no_improvement=100,
        train_predictor=pkg.StandardPredict(image_names=["X", "y"], **device),
        validation_predictor=pkg.StandardPredict(image_names=["X"], **device),
        train_dataloader_factory=pkg.StandardDataLoader(sampler=pkg.SequentialSampler),
        validation_dataloader_factory=pkg.StandardDataLoader(sampler=pkg.SequentialSampler),
        mesh=mesh, spatial_axis=spatial_axis, **extra)
    return context


class RecordingLogger(tsp.NonLogger):
    def __init__(self):
        self.records = []

    def log(self, log_dict):
        self.records.append(log_dict)


SPATIAL_ITERATIONS = 4


def spatial_trainer_run(root, mesh, spatial_axis, checkpoint=None, optimizer=("Adam", 3e-3),
                        state=None):
    """4 iterations of the port's trainer with ``optimizer``, from
    ``state`` (numpy weights) where given: the losses and training Dice by
    iteration, the final parameters and the final state; the context
    saved to ``checkpoint`` where given."""
    tsp.seed_all(0)
    context = spatial_context(tsp, root, mesh, spatial_axis, optimizer)
    context.init_components()
    if state is not None:
        context.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    logger = RecordingLogger()
    context.trainer.train(context, max_iterations=SPATIAL_ITERATIONS, logger=logger)
    if checkpoint is not None:
        context.save(checkpoint)
    losses = {r["iteration"]: r["loss"] for r in logger.records if "loss" in r}
    dices = {r["iteration"]: float(r["seg"]["summary_stats"]["mean", "fg", "dice"])
             for r in logger.records if "seg" in r}
    params = {k: v.detach().numpy().copy() for k, v in context.model.params.items()}
    return dict(losses=losses, dices=dices, params=params, iteration=context.trainer.iteration,
                state={k: v.numpy().copy() for k, v in context.model.state_dict().items()})


def spatial_trainer_sgd_ranks(rank, world, root, state, lr):
    """The spatial trainer on a (2,) mesh with SGD from ``state``, for
    tests/test_torch_spatial.py to hold against JAX's trainer."""
    mesh = tsp.make_mesh(world, ("spatial",), device="cpu")
    return spatial_trainer_run(root, mesh, "spatial", optimizer=("SGD", lr), state=state)


def spatial_trainer_ranks(rank, world, root, checkpoint):
    """The spatial trainer's run (rank 0 saves its checkpoint), two more
    iterations on the context reloaded from it, and the refusals."""
    mesh = tsp.make_mesh(world, ("spatial",), device="cpu")
    result = spatial_trainer_run(root, mesh, "spatial", checkpoint if rank == 0 else None)
    torch.distributed.barrier()
    resumed = tsp.Context("cpu", file_path=checkpoint)
    resumed.init_components()
    trainer = resumed.trainer
    logger = RecordingLogger()
    trainer.train(resumed, max_iterations=2, logger=logger)
    result["resumed"] = (trainer.mesh.shape, trainer.mesh.coords, trainer.spatial_axis,
                         trainer.iteration, [r["loss"] for r in logger.records if "loss" in r])
    # the refusals, as the JAX trainer's
    refusals = []
    for extra in ({"device_cache": True}, {"device_augmentation": {}}):
        context = spatial_context(tsp, root, mesh, "spatial", **extra)
        context.init_components()
        with pytest.raises(ValueError, match="spatial") as refused:
            context.trainer.train(context, max_iterations=1, logger=tsp.NonLogger())
        refusals.append(str(refused.value))
    result["refusals"] = refusals
    return result


def replica_step_ranks(rank, world, spec):
    """The data-parallel step (sagittal split) on a (2, 2) data x model
    mesh: the batch shards over the data axis and the model axis holds
    replicas, as GSPMD places a batch sharded over 'data' only."""
    mesh = tsp.make_mesh(world, ("data", "model"), (2, 2), device="cpu")
    return run_step(spec, mesh)


def cases_ranks(rank, world, cases):
    """Several bodies in one spawn: ``cases`` is [(body name, args), ...]."""
    return [globals()[name](rank, world, *args) for name, args in cases]


# ---- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def dropout_runs(tmp_path_factory):
    """The spatial step at dropout 0.2: 2 ranks on a (2,) spatial mesh
    (W=32, batch 2) and 4 on a (2, 2) data x spatial mesh (W=16, batch 4),
    beside the one-device step on the same batches."""
    spatial = step_spec(2, 32, dropout=0.2, steps=2)
    both = step_spec(4, 16, dropout=0.2, steps=2, seed=1)
    replicas = mesh_step_spec(dropout=0.2, steps=2)
    two = spawn_ranks(cases_ranks, 2, tmp_path_factory.mktemp("spatial2"),
                      [("spatial_step_ranks", (spatial, ("spatial",), (2,), None))])
    four = spawn_ranks(cases_ranks, 4, tmp_path_factory.mktemp("spatial4"),
                       [("spatial_step_ranks", (both, ("data", "spatial"), (2, 2), "data")),
                        ("replica_step_ranks", (replicas,))])
    return dict(steps=[(spatial, [r[0] for r in two], run_spatial_step(spatial), 1),
                       (both, [r[0] for r in four], run_spatial_step(both), 2)],
                replicas=(replicas, [r[1] for r in four], run_step(replicas)))


@pytest.mark.parametrize("case", [0, 1], ids=["spatial-2", "data2-x-spatial2"])
def test_spatial_step_matches_one_device_step_with_dropout(dropout_runs, case):
    """The spatial step at dropout 0.2 against the one-device step on the
    whole batch: each rank's dropout masks are the one-device masks at its
    rows (data coordinate r of D holds rows [r n / D, (r + 1) n / D)), so
    they are the same on every slab of a sample; the global loss on every
    rank within 1e-5 of the one-device loss; each rank's prediction is its
    slab of the one-device prediction; all ranks hold the same weights,
    within 1e-4 of the one-device weights. Each rank exchanged halos in
    the forward and the backward of every step."""
    spec, ranks, single, data = dropout_runs["steps"][case]
    n = len(spec["batch"]["X"])
    per = n // data
    W = spec["batch"]["X"].shape[2]
    w = W // 2
    assert len(single["masks"]) == 2 * 10  # 10 blocks a forward, 2 steps
    for r, result in enumerate(ranks):
        d, s = divmod(r, 2) if data > 1 else (0, r)
        rows = slice(d * per, (d + 1) * per)
        assert len(result["masks"]) == len(single["masks"])
        for mask, full in zip(result["masks"], single["masks"]):
            np.testing.assert_array_equal(mask, full[rows])
        for got, want in zip(result["losses"], single["losses"]):
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(result["y_pred"], single["y_pred"][rows, s * w:(s + 1) * w],
                                   atol=1e-4)
        # 25 convs and 6 upsamples a forward; backward all but the two
        # convs that read the network's input, which needs no gradient
        assert result["traffic"]["calls"] == spec["steps"] * (31 + 29), result["traffic"]
    assert any(m.mean() < 1 for m in single["masks"])  # something was dropped
    for key, value in single["state"].items():
        for result in ranks[1:]:
            np.testing.assert_array_equal(result["state"][key], ranks[0]["state"][key])
        if value.dtype.kind == "f":
            np.testing.assert_allclose(ranks[0]["state"][key], value, rtol=1e-4, atol=1e-6,
                                       err_msg=key)


def test_data_parallel_step_with_replicas_matches_one_device_step(dropout_runs):
    """The data-parallel step on a (2, 2) data x model mesh, whose model
    axis is wider than 1 but not sharded: the two replicas of each data
    shard take its rows of the split batch, the same dropout masks and
    the same steps; the loss on every rank within 1e-5 of the one-device
    loss; all four ranks hold the same weights, within 1e-4 of the
    one-device weights."""
    spec, ranks, single = dropout_runs["replicas"]
    n = len(spec["batch"]["X"])
    for r, result in enumerate(ranks):
        rows = split_rows(r // 2, 2, n)
        for mask, full in zip(result["masks"], single["masks"]):
            np.testing.assert_array_equal(mask, full[rows])
        for got, want in zip(result["losses"], single["losses"]):
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    for key, value in single["state"].items():
        for result in ranks[1:]:
            np.testing.assert_array_equal(result["state"][key], ranks[0]["state"][key])
        if value.dtype.kind == "f":
            np.testing.assert_allclose(ranks[0]["state"][key], value, rtol=1e-4, atol=1e-6,
                                       err_msg=key)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial-trainer") / "data"
    write_spatial_dataset(root)
    ranks = spawn_ranks(cases_ranks, 2, root.parent / "ranks",
                        [("spatial_trainer_ranks", (str(root), str(root.parent / "sp.ckpt")))])
    return root, [r[0] for r in ranks]


def test_spatial_trainer_matches_one_device_trainer(trainer_runs):
    """SegmentationTrainer(spatial_axis="spatial") on a (2,) mesh, the JAX
    package's TestTrainerSpatialSharding setup (Adam 3e-3, batch 2 of 32 x
    16 x 8, 4 iterations), against the one-device trainer from one seed:
    the first loss within 1e-5, the later ones within 1e-3, the scheduled
    training Dice (on the prediction gathered from the slabs) within 0.02,
    both ranks' weights equal; with the device cache or the device
    augmentation it refuses, as JAX's. Reloaded from rank 0's checkpoint,
    the trainer rebuilds its (2,) spatial mesh from the recipe, keeps
    spatial_axis and trains on."""
    root, ranks = trainer_runs
    single = spatial_trainer_run(root, None, None)
    assert sorted(single["losses"]) == list(range(SPATIAL_ITERATIONS))
    result = ranks[0]  # rank 0 writes the log records
    assert ranks[1]["losses"] == {} and ranks[1]["dices"] == {}
    np.testing.assert_allclose(result["losses"][0], single["losses"][0], rtol=1e-5)
    for it, loss in single["losses"].items():
        np.testing.assert_allclose(result["losses"][it], loss, rtol=1e-3)
    assert sorted(result["dices"]) == sorted(single["dices"]) == [0, 2]
    for it, dice in single["dices"].items():
        np.testing.assert_allclose(result["dices"][it], dice, atol=0.02)
    for result in ranks:
        assert result["iteration"] == SPATIAL_ITERATIONS
        assert "device_cache with spatial sharding" in result["refusals"][0]
        assert "device_augmentation with spatial_axis" in result["refusals"][1]
    for key, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][key], value)
    for r, result in enumerate(ranks):
        shape, coords, axis, iteration, losses = result["resumed"]
        assert (shape, coords, axis) == ({"spatial": 2}, {"spatial": r}, "spatial")
        assert iteration == SPATIAL_ITERATIONS + 2
    assert len(ranks[0]["resumed"][-1]) == 2 and all(np.isfinite(ranks[0]["resumed"][-1]))


def test_halo_exchange_values_gradient_and_traffic(tmp_path):
    """At 3 ranks (the middle one has two neighbours): each rank's widened
    slab is the whole tensor's rows [r w - 2, (r + 1) w + 2) with zeros past
    the ends; the input gradient of sum(ext * g) is, on each row, the sum
    of g over the places where that row landed; the sharded conv is the
    whole conv's slab. Each rank contributed its 4 edge rows to the
    exchange and to its backward, and its 2 edge rows to the conv's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 4, 3, 2)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 3, 2, 5)).astype(np.float32)
    g = rng.normal(size=(16, 4, 3, 2)).astype(np.float32)  # cotangents of the widened rows
    ranks = spawn_ranks(cases_ranks, 3, tmp_path, [("halo_ranks", (x, kernel, g))])
    padded = np.pad(x, ((2, 2), (0, 0), (0, 0), (0, 0)))
    dx = np.zeros_like(x)
    for r in range(3):
        for i in range(8):  # row i of rank r's widened slab is global row 4r + i - 2
            if 0 <= 4 * r + i - 2 < 12:
                dx[4 * r + i - 2] += g[4 * r + i]
    whole = tsp.ops.convolution.conv3d(torch.from_numpy(x)[None], torch.from_numpy(kernel),
                                       padding=1)[0].numpy()
    for r, (result,) in enumerate(ranks):
        np.testing.assert_array_equal(result["ext"], padded[4 * r:4 * r + 8])
        np.testing.assert_allclose(result["dx"], dx[4 * r:4 * r + 4], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(result["conv"], whole[4 * r:4 * r + 4], rtol=1e-5, atol=1e-5)
        row = 4 * 3 * 2 * 4  # the bytes of one float32 row
        assert result["traffic"] == {"calls": 3, "bytes": (4 + 4 + 2) * row}
