"""The port's data-parallel mesh against its own one-device runs, on the CPU,
with the ranks as spawned gloo processes; and the rank bodies that
tests/test_torch_mesh.py holds against the JAX package.

This file imports no JAX: a spawned rank imports it by name to find its
body. ``spawn_ranks`` starts ``world`` processes by the launcher's own
``spawn_ranks`` and joins them through a rendezvous file under the test's
tmp_path (parallel test workers never share a port),
with a timeout on the process group and on every join, so a hang fails in
seconds. Every rank runs the same code from the same seed, as the mesh's
users do.

Cases: the one-rank mesh, recipes and what still raises (item 10b); the
mesh train step at 2 ranks against the one-device step with dropout 0.2
and the sagittal split (the dropout masks bit for bit at their global
rows, the loss within 1e-5); the mesh trainer (dmri_hippo's fast path: the
device cache, the derived device augmentation, dropout) against the
one-device trainer, and its resume from a checkpoint with its
``MeshRecipe``; the ranks stopping at one iteration when one rank alone
is signalled or their clocks start apart; the launcher starting and joining 2 ranks, and failing when
a rank fails.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.models import components
from segmentation_pipeline_torch.parallel import mesh as tmesh
from segmentation_pipeline_torch.research.scripts import launch_multihost as launcher
from segmentation_pipeline_torch.training import trainer as ttrainer

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120
COLLECTIVE_TIMEOUT_S = 60
CROP, FILTERS = (16, 16, 8), 4


# ---- spawning ranks ----------------------------------------------------

def _rank_entry(rank, body, world, init, folder, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = body(rank, world, *args)
        with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(folder, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(body, world, folder, *args):
    """``body(rank, world, *args)`` in ``world`` processes joined by gloo,
    started and stopped by the launcher's ``spawn_ranks``; returns their
    results in rank order. A rank that fails or hangs fails the call with
    its traceback; no process outlives it."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    init = f"file://{folder / 'rendezvous'}"
    try:
        launcher.spawn_ranks(world, _rank_entry, (body, world, init, str(folder), args),
                             JOIN_TIMEOUT_S)
    except SystemExit as failed:
        errors = [folder / f"rank{r}.err" for r in range(world)]
        raise AssertionError("\n".join([str(failed)] + [e.read_text() for e in errors
                                                         if e.exists()])) from None
    out = []
    for r in range(world):
        with open(folder / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---- the train step ----------------------------------------------------

def step_spec(filters=FILTERS, n=4, dropout=0.0, steps=3, seed=0):
    """A NestedResUNet(3 -> 2) state in the port's layout (from
    chip_smoke.flax_weights: non-trivial BatchNorm statistics) and a global
    batch of ``n`` subjects of 3 x CROP."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    variables = chip_smoke.flax_weights(rng, filters)
    state = {k: v.numpy() for k, v in tsp.flax_to_state_dict(variables).items()}
    X = rng.normal(size=(n, 3, *CROP)).astype(np.float32)
    lab = (X[:, 0] > 0.3).astype(np.float32)
    return dict(variables=variables, state=state, batch={"X": X, "y": np.stack([1 - lab, lab], 1)},
                filters=filters, dropout=dropout, steps=steps, lr=2e-4)


@contextlib.contextmanager
def recorded_dropout(masks):
    """Every channel dropout of the block records its (rows, channels) keep
    mask, drawn by the port's own ``channel_dropout``."""
    original = components.channel_dropout

    def recording(x, p, generator, shard=None):
        scale = original(torch.ones((x.shape[0], 1, 1, 1, x.shape[-1]), dtype=x.dtype,
                                    device=x.device), p, generator, shard)
        masks.append((scale != 0).reshape(x.shape[0], -1).cpu().numpy())
        return x * scale

    components.channel_dropout = recording
    try:
        yield
    finally:
        components.channel_dropout = original


def run_step(spec, mesh=None):
    """The port's step ``spec["steps"]`` times on ``spec``'s global batch
    (on a mesh, this rank's rows), sagittal split, Adam: the losses, the
    final state (numpy), the last prediction and the dropout masks."""
    model = tsp.SegModel(tsp.NestedResUNet(3, 2, filters=spec["filters"],
                                           dropout_p=spec["dropout"]), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state"].items()})
    optimizer = tsp.Adam(lr=spec["lr"])
    state = tsp.create_train_state(model, optimizer, spec["batch"])
    step = tsp.make_train_step(model.module, tsp.HybridLogisticDiceLoss(), optimizer, mesh=mesh,
                               sagittal_split=True)
    generator = torch.Generator().manual_seed(7)
    batch = tsp.collate_to_device(spec["batch"], device="cpu", mesh=mesh)
    losses, masks = [], []
    with recorded_dropout(masks):
        for _ in range(spec["steps"]):
            state, loss_dict, y_pred = step(state, batch, generator)
            losses.append({k: v.item() for k, v in loss_dict.items()})
    return dict(losses=losses, masks=masks, y_pred=y_pred.numpy(),
                state={k: v.numpy().copy() for k, v in model.module.state_dict().items()})


def step_ranks(rank, world, spec):
    mesh = tsp.make_mesh(world, ("data", "model"), (world, 1), device="cpu")
    return run_step(spec, mesh)


def split_rows(rank, world, n):
    """The global rows of the sagittal split batch (2n) that ``rank`` holds."""
    per = n // world
    local = np.arange(rank * per, (rank + 1) * per)
    return np.concatenate([local, n + local])


# ---- BatchNorm alone -----------------------------------------------------

def batchnorm_ranks(rank, world, x, w):
    """One train-mode BatchNorm over this rank's rows of x (channels-last),
    with the global batch's statistics; loss sum(out * w) over the rows.
    Returns the rows' output and input gradient, the parameter gradients
    summed over the ranks and the running statistics."""
    mesh = tsp.make_mesh(device="cpu")
    rows = mesh.rows(len(x))
    norm = components.BatchNorm(x.shape[-1])
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        norm.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[-1]))
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    with components.data_parallel(norm, tmesh.BatchShard.of(mesh, len(x))):
        out = norm.train()(xt)
        (out * torch.from_numpy(w[rows])).sum().backward()
    tmesh.all_reduce_gradients(list(norm.parameters()), mesh)
    return dict(out=out.detach().numpy(), dx=xt.grad.numpy(), dscale=norm.weight.grad.numpy(),
                dbias=norm.bias.grad.numpy(), mean=norm.running_mean.numpy(),
                var=norm.running_var.numpy())


# ---- serving: the ensembles, the sliding window, PatchPredict -----------

def port_model(state, filters=FILTERS):
    model = tsp.SegModel(tsp.NestedResUNet(3, 2, filters=filters), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def patch_dependent(patches):
    """A model whose output depends on the whole patch."""
    return patches * 2.0 + patches.mean(dim=(1, 2, 3, 4), keepdim=True)


def serving_ranks(rank, world, state, inputs):
    """The serving paths on a mesh of ``world`` ranks, each where
    ``inputs`` (name -> array) asks for it: EnsembleFlips over all three
    dims and over dims (4,) ("flips_w": 2 members, padded at 4 ranks),
    EnsembleAffines at given matrices (3 members: padded at 2 and 4 ranks),
    EnsembleOrientations, distributed_sliding_window with the network
    (27 locations: padded) and with a patch-dependent model in hann mode,
    and PatchPredict(mesh=...) on one subject."""
    mesh = tsp.make_mesh(device="cpu")
    model = port_model(state)
    module = model.module.eval()
    ensembles = {
        "flips": lambda: tsp.EnsembleFlips(model, "mean", mesh=mesh),
        "flips_w": lambda: tsp.EnsembleFlips(model, "mean", spatial_dims=(4,), mesh=mesh),
        "orientations": lambda: tsp.EnsembleOrientations(model, "mean", mesh=mesh)}
    out = {}
    with torch.no_grad():
        for name, make in ensembles.items():
            if name in inputs:
                out[name] = make()(torch.from_numpy(inputs[name])).numpy()
        if "affines" in inputs:
            x, matrices = inputs["affines"]
            affines = tsp.EnsembleAffines(model, num_members=len(matrices), strategy="mean",
                                          mesh=mesh)
            affines.matrices = [m.copy() for m in matrices]
            out["affines"] = affines(torch.from_numpy(x)).numpy()
    if "window" in inputs:
        out["window"] = tsp.parallel.distributed_sliding_window(
            torch.from_numpy(inputs["window"]), lambda p: module(p), 8, 4, patch_batch=2,
            mesh=mesh).numpy()
    if "window_hann" in inputs:
        out["window_hann"] = tsp.parallel.distributed_sliding_window(
            torch.from_numpy(inputs["window_hann"]), patch_dependent, 8, 4, patch_batch=4,
            mode="hann", mesh=mesh).numpy()
    if "patch_predict" in inputs:
        predictor = tsp.PatchPredict(patch_size=8, patch_overlap=4, patch_batch_size=4,
                                     mesh=mesh, device="cpu")
        subject = tsp.Subject({"X": tsp.ScalarImage(tensor=inputs["patch_predict"],
                                                    affine=np.eye(4))})
        _, batch = predictor.predict(model, [subject])
        out["patch_predict"] = batch["y_pred"]
    return out


def cases_ranks(rank, world, cases):
    """Several bodies in one spawn: ``cases`` is [(body name, args), ...]."""
    return [globals()[name](rank, world, *args) for name, args in cases]


# ---- the trainer ---------------------------------------------------------

TRAINER_ITERATIONS = 4


def trainer_context(root, mesh, batch_size=4):
    """dmri_hippo's ported configuration on its fast path (the device cache,
    the device augmentation derived from its pipeline, dropout 0.2) at a
    small size, validated by a PatchPredict on ``mesh`` every 2 iterations."""
    from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config

    context = main_config.get_context(device="cpu", variables={"DATASET_PATH": str(root)},
                                      crop_shape=CROP, filters=FILTERS, tpu_fast_path=True,
                                      training_batch_size=batch_size)
    validation = [tsp.ScheduledEvaluation(
        evaluator=tsp.SegmentationEvaluator("y_pred_eval", "y_eval"), log_name="seg",
        cohorts=["cbbrain_validation"], interval=2)]
    context.update_component(
        "trainer", mesh=mesh, save_rate=100, validation_evaluators=validation,
        training_evaluators=[], max_iterations_with_no_improvement=100,
        scoring_function=lambda d: -float(d["loss"]) if "loss" in d else 0.0,
        validation_predictor=tsp.PatchPredict(image_names=["X"], patch_size=8, patch_overlap=4,
                                              patch_batch_size=4, mesh=mesh, device="cpu"))
    context.init_components()
    return context


class RecordingLogger(tsp.NonLogger):
    def __init__(self):
        self.records, self.saved = [], []

    def log(self, log_dict):
        self.records.append(log_dict)

    def save_context(self, context, folder, iteration):
        self.saved.append((folder, iteration))


def summary(logger):
    losses = {r["iteration"]: r["loss"] for r in logger.records if "loss" in r}
    dices = {r["iteration"]: float(r["seg"]["cbbrain_validation"]["summary_stats"][
        "mean", "left_whole", "dice"]) for r in logger.records if "seg" in r}
    return losses, dices, logger.saved


def train_run(root, mesh, checkpoint=None):
    tsp.seed_all(1234)
    context = trainer_context(root, mesh)
    logger = RecordingLogger()
    context.trainer.train(context, max_iterations=TRAINER_ITERATIONS, logger=logger)
    if checkpoint is not None:
        context.save(checkpoint)
    return context, logger


def trainer_ranks(rank, world, root, checkpoint):
    """The mesh trainer's run, its checkpoint (rank 0 writes it), and two
    more iterations from that checkpoint on a reloaded context."""
    mesh = tsp.make_mesh(device="cpu")
    context, logger = train_run(root, mesh, checkpoint if rank == 0 else None)
    params = {k: v.numpy().copy() for k, v in context.model.module.state_dict().items()}
    dist.barrier()
    resumed = tsp.Context("cpu", file_path=checkpoint, variables={"DATASET_PATH": str(root)})
    resumed.init_components()
    recipe = (resumed.trainer.mesh.shape, resumed.trainer.mesh.rank,
              resumed.trainer.validation_predictor.mesh)
    resumed_logger = RecordingLogger()
    resumed.trainer.train(resumed, max_iterations=2, logger=resumed_logger)
    return dict(summary=summary(logger), params=params, recipe=recipe,
                resumed=summary(resumed_logger), iteration=resumed.trainer.iteration)


STOP_SKEW_S, STOP_BUDGET_S = 1.0, 2


class SignallingLogger(RecordingLogger):
    """Sets the trainer's stop flag in its own process once iteration
    ``at`` is logged, as a signal to that rank alone would."""

    def __init__(self, at):
        super().__init__()
        self.at = at

    def log(self, log_dict):
        super().log(log_dict)
        if log_dict.get("iteration") == self.at:
            ttrainer.EXIT.set()


def stop_ranks(rank, world, root, how):
    """The mesh trainer stopped by rank 0's signal after iteration 1
    ("signal": rank 1 logs nothing, so only rank 0 sets the flag) or by a
    time budget with rank 1 starting STOP_SKEW_S after rank 0 ("time"):
    the iteration this rank stopped at, and what its logger saved."""
    mesh = tsp.make_mesh(device="cpu")
    context = trainer_context(root, mesh)
    if how == "signal":
        logger, budget = SignallingLogger(1), None
    else:
        logger, budget = RecordingLogger(), STOP_BUDGET_S
        if rank == 1:
            time.sleep(STOP_SKEW_S)
    context.trainer.train(context, max_iterations=1000, max_training_time=budget,
                          logger=logger)
    return context.trainer.iteration, logger.saved


# ---- the tests -----------------------------------------------------------

def test_one_rank_mesh_recipes_and_what_raises():
    """Without a process group a mesh has one rank on the caller's device;
    its collectives are the identity. A recipe rebuilds it and refuses a
    mesh larger than the group; axes other than the data axis shard
    volumes (item 10b)."""
    assert not dist.is_initialized()
    mesh = tsp.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.size, mesh.distributed) == ({"data": 1}, 0, 1, False)
    assert tsp.make_mesh(1, ("data", "model"), (1, 1), device="cpu").shape == \
        {"data": 1, "model": 1}
    x = torch.arange(6.0).reshape(3, 2)
    assert tmesh.all_reduce_sum(x, mesh) is x and tmesh.all_gather_rows(x, mesh) is x
    recipe = tsp.MeshRecipe.of(mesh)
    assert pickle.loads(pickle.dumps(recipe)).build("cpu").shape == mesh.shape
    with pytest.raises(RuntimeError, match="needs 2 devices but only 1"):
        tsp.MeshRecipe(("data",), (2,)).build("cpu")
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        tsp.make_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10b"):
        tmesh.Mesh(("data", "model"), (1, 2), 0, "cpu", False)
    with pytest.raises(NotImplementedError, match="item 10b"):
        tsp.collate_to_device({"X": np.zeros((1, 1, 2, 2, 2))}, device="cpu", mesh=mesh,
                              spatial_axis="model")
    with pytest.raises(NotImplementedError, match="item 10b"):
        tsp.PatchPredict(patch_size=8, volume_sharded=True, device="cpu")
    padded, n = tsp.parallel.pad_batch_to_devices({"X": np.ones((5, 2)), "y": np.ones((5, 3))}, 4)
    assert n == 5 and padded["X"].shape == (8, 2) and padded["X"][5:].sum() == 0
    batch = tsp.parallel.shard_batch({"X": np.arange(4)}, mesh)
    assert batch["X"].tolist() == [0, 1, 2, 3]


@pytest.fixture(scope="module")
def dropout_runs(tmp_path_factory):
    spec = step_spec(dropout=0.2, steps=2)
    ranks = spawn_ranks(step_ranks, 2, tmp_path_factory.mktemp("step-ranks"), spec)
    return spec, ranks, run_step(spec)


def test_mesh_step_matches_one_device_step_with_dropout(dropout_runs):
    """dmri_hippo's step (sagittal split, dropout 0.2) at 2 ranks of 2
    subjects against one device with all 4: each rank's dropout masks are
    the one-device masks at its global rows of the split batch (half 1 of
    subject i at row i, half 2 at row 4 + i), bit for bit; the global loss
    on both ranks within 1e-5 of the one-device loss; both ranks hold the
    same weights, within 1e-4 of the one-device weights."""
    spec, ranks, single = dropout_runs
    n = len(spec["batch"]["X"])
    assert len(single["masks"]) == 2 * 10  # 10 blocks a forward, 2 steps
    for r, result in enumerate(ranks):
        assert len(result["masks"]) == len(single["masks"])
        rows = split_rows(r, 2, n)
        for mask, full in zip(result["masks"], single["masks"]):
            np.testing.assert_array_equal(mask, full[rows])
        for got, want in zip(result["losses"], single["losses"]):
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
        np.testing.assert_allclose(result["y_pred"], single["y_pred"][r * 2:(r + 1) * 2],
                                   atol=1e-4)
    assert any(m.mean() < 1 for m in single["masks"])  # something was dropped
    for key, value in single["state"].items():
        np.testing.assert_array_equal(ranks[0]["state"][key], ranks[1]["state"][key])
        if value.dtype.kind == "f":
            np.testing.assert_allclose(ranks[0]["state"][key], value, rtol=1e-4, atol=1e-6,
                                       err_msg=key)


def write_trainer_dataset(root):
    import chip_smoke

    with contextlib.ExitStack() as stack:
        # a small grid: the crop is 16 x 16 x 8
        stack.enter_context(patched_attr(chip_smoke, "ORIGINAL_GRID", (20, 18, 6)))
        stack.enter_context(patched_attr(chip_smoke, "HIPPO_SUBJECTS",
                                         {"validation": 2, "training": 8, "ab300": 0}))
        chip_smoke.write_hippo_dataset(str(root), 3)


@contextlib.contextmanager
def patched_attr(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """One spawn of 2 ranks: the mesh trainer with its resume, then the
    two stopped runs; the dataset beside them."""
    tmp_path = tmp_path_factory.mktemp("trainer")
    root = tmp_path / "data"
    write_trainer_dataset(root)
    checkpoint = tmp_path / "mesh.ckpt"
    ranks = spawn_ranks(cases_ranks, 2, tmp_path / "ranks",
                        [("trainer_ranks", (str(root), str(checkpoint))),
                         ("stop_ranks", (str(root), "signal")),
                         ("stop_ranks", (str(root), "time"))])
    return root, ranks


def test_mesh_trainer_matches_one_device_trainer_and_resumes(trainer_runs):
    """The trainer on 2 ranks (batch 4: 2 a rank) against one device, from
    one seed: the composed batch (the cache's gather, the device
    augmentation) and the dropout masks are the one-device ones, so the
    first loss agrees within 1e-5 and the later ones within 1e-3; the
    PatchPredict(mesh) validation sweeps agree. Rank 0 alone wrote log
    records and checkpoints. Reloaded from its checkpoint, the trainer
    rebuilds its mesh and the validation predictor's from their recipes
    and trains on."""
    root, ranks = trainer_runs
    ranks = [result[0] for result in ranks]
    _, logger = train_run(root, None)
    losses, dices, saved = summary(logger)
    assert sorted(losses) == list(range(TRAINER_ITERATIONS))
    (mesh_losses, mesh_dices, mesh_saved), (other_losses, _, other_saved) = \
        ranks[0]["summary"], ranks[1]["summary"]
    assert other_losses == {} and other_saved == []  # rank 1 wrote nothing
    assert mesh_saved == saved
    np.testing.assert_allclose(mesh_losses[0], losses[0], rtol=1e-5)
    for it in losses:
        np.testing.assert_allclose(mesh_losses[it], losses[it], rtol=1e-3)
    assert sorted(mesh_dices) == sorted(dices) == [0, 2]
    for it in dices:
        np.testing.assert_allclose(mesh_dices[it], dices[it], atol=0.02)
    for key, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][key], value)
    shape, rank, predictor_mesh = ranks[1]["recipe"]
    assert shape == {"data": 2} and rank == 1 and isinstance(predictor_mesh, tsp.MeshRecipe)
    assert ranks[0]["iteration"] == TRAINER_ITERATIONS + 2
    resumed_losses = ranks[0]["resumed"][0]
    assert sorted(resumed_losses) == [TRAINER_ITERATIONS, TRAINER_ITERATIONS + 1]
    assert all(np.isfinite(v) for v in resumed_losses.values())


@pytest.mark.parametrize("how", ["signal", "time"])
def test_mesh_trainer_ranks_stop_together(trainer_runs, how):
    """Each rank reads its own clock and signals, yet both stop at one
    iteration, before max_iterations, and rank 0 writes the exit
    checkpoint there: with a stop flag set on rank 0 alone after
    iteration 1, and with a time budget whose ranks started STOP_SKEW_S
    apart. (A rank that stopped alone would leave the other waiting in
    the next step's all-reduce until the group's timeout.)"""
    _, ranks = trainer_runs
    (iteration, saved), (other_iteration, other_saved) = \
        [result[1 if how == "signal" else 2] for result in ranks]
    assert iteration == other_iteration < 999
    if how == "signal":
        assert iteration <= 2  # logged at once, or one iteration late when deferred
    assert saved[-1] == ("checkpoints/", iteration) and other_saved == []


def test_launcher_starts_and_joins_two_ranks(tmp_path):
    """``launch_multihost`` without --coordinator spawns the ranks, joins
    them (gloo on the CPU) and runs the module in each; a failing rank
    fails the launch and leaves no rank running."""
    script = tmp_path / "probe_rank.py"
    script.write_text(
        "import sys, torch, torch.distributed as dist\n"
        "import segmentation_pipeline_torch as tsp\n"
        "mesh = tsp.make_mesh(device='cpu')\n"
        "total = tsp.parallel.all_reduce_sum(torch.tensor([mesh.rank + 1.0]), mesh)\n"
        "open(sys.argv[1] + f'/rank{mesh.rank}', 'w').write(f'{mesh.size} {total.item()}')\n"
        "if len(sys.argv) > 2 and mesh.rank == 1: sys.exit(3)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{tmp_path}")
    command = [sys.executable, "-m", "segmentation_pipeline_torch.research.scripts."
               "launch_multihost", "--num-processes", "2", "--timeout", "30", "--",
               "probe_rank", str(tmp_path)]
    done = subprocess.run(command, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=JOIN_TIMEOUT_S)
    assert done.returncode == 0, done.stderr
    assert [(tmp_path / f"rank{r}").read_text() for r in range(2)] == ["2 3.0"] * 2
    assert "process 1/2: backend gloo" in done.stdout
    failed = subprocess.run(command + ["fail"], cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=JOIN_TIMEOUT_S)
    assert failed.returncode != 0 and "rank 1 of 2 exited with code 3" in failed.stderr
