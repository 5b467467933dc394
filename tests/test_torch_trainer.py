"""The port's training loop against the JAX package's on the CPU: a subject
folder written by the port's NIfTI codec, a Context with SubjectFolder, a
tiny NestedResUNet at the same weights (dropout 0), Adam, the hybrid loss
and SegmentationTrainer with scheduled training and validation evaluators,
scoring and checkpoints, both driven through ``trainer.train`` with a
FileLogger, from the same host seed. The losses, the schedule, the
evaluator outputs and the checkpoint files must agree. Then, on the port
alone: a resume from a checkpoint repeats the uninterrupted run bit for
bit, an asynchronous save holds its own iteration's weights, early stops
land on JAX's iterations, what the port does not do yet raises, and a
hybrid split trains with the device cache, whichever lever is set first.

Each iteration of the port starts from the weights and Adam moments the
JAX run had at that iteration (``follow_jax``). Left to run freely, two
float32 runs of this fixture part by more than 1e-5 within a few
iterations: Adam scales each gradient element to about ``lr``, so elements
whose gradients sit at the level of rounding noise take steps of noise-set
size and sign. The JAX package against itself, with only the order of the
subjects in each batch reversed, parts by more than 1e-5 within eight
steps (``test_free_running_float32_adam_parts_beyond_the_tolerance``).
Before it overwrites them, ``follow_jax`` holds the state the port carried
from its previous step (weights, BatchNorm statistics, Adam's moments and
count) against JAX's at that iteration, so the carrying itself is tested.
"""
import json
import math
import threading

import jax
import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_tpu.loggers import FileLogger as JFileLogger
from segmentation_pipeline_tpu.training import trainer as jtrainer
from segmentation_pipeline_torch.models import flax_to_state_dict, state_dict_to_flax
from segmentation_pipeline_torch.training import trainer as ttrainer

torch.set_num_threads(2)

ITERATIONS = 21
SHAPE = (16, 16, 8)
LOSS_RTOL = 1e-5
# The weights and Adam moments of one step from a shared state: ||port -
# jax|| / ||jax|| over the whole tree. JAX's own step, with the batch order
# reversed, parts its weights by 5e-5 after one step (held by the
# free-running test below); this is that spread rounded up.
STATE_RTOL = 1e-4


def build_dataset(root, n=4, shape=SHAPE):
    """The fixture of tests/test_trainer.py, written by the port's codec."""
    rng = np.random.default_rng(0)
    for i in range(n):
        d = root / "subjects" / f"sub-{i:02d}"
        d.mkdir(parents=True)
        img = rng.normal(scale=0.3, size=(1, *shape)).astype(np.float32)
        seg = np.zeros((1, *shape), np.int16)
        seg[:, 4:12, 4:12, 2:6] = 1
        img[seg.astype(bool)] += 2.0
        tsp.write_nifti(d / "t1.nii.gz", img, np.eye(4))
        tsp.write_nifti(d / "seg.nii.gz", seg, np.eye(4))
        with open(d / "attributes.json", "w") as f:
            json.dump({"fold": i % 2}, f)


def scoring_function(evaluation_dict):
    seg_eval = evaluation_dict["segmentation_eval"]["validation"]["summary_stats"]
    return float(seg_eval["mean", :, "dice"].mean())


def constant_score(evaluation_dict):
    return 0.0


def build_context(pkg, root, train_sampler="RandomSampler", **trainer_kwargs):
    """tests/test_trainer.py's context on ``pkg``; the port's on the CPU."""
    on_cpu = {"device": "cpu"} if pkg is tsp else {}
    loader = pkg.ComposeLoaders([
        pkg.ImageLoader(glob_pattern="t1.*", image_name="t1", image_constructor=pkg.ScalarImage),
        pkg.ImageLoader(glob_pattern="seg.*", image_name="seg", image_constructor=pkg.LabelMap,
                        label_values={"fg": 1}),
        pkg.AttributeLoader(glob_pattern="attributes.*"),
    ])
    cohorts = {
        "all": pkg.RequireAttributes(["t1"]),
        "training": pkg.ForbidAttributes({"fold": 0}),
        "validation": pkg.RequireAttributes({"fold": 0}),
    }
    transforms = {"default": pkg.Compose([
        pkg.RescaleIntensity((-1, 1), (0.5, 99.5)),
        pkg.ConcatenateImages(image_names=["t1"], image_channels=[1], new_image_name="X"),
        pkg.RenameProperty(old_name="seg", new_name="y"),
        pkg.CustomOneHot(include=["y"]),
    ])}
    context = pkg.Context("cpu", name="e2e-test", variables={"DATASET_PATH": str(root)})
    context.add_component("dataset", pkg.SubjectFolder, root="$DATASET_PATH",
                          subject_path="subjects", subject_loader=loader, cohorts=cohorts,
                          transforms=transforms)
    context.add_component("model", pkg.NestedResUNet, input_channels=1, output_channels=2,
                          filters=4)
    context.add_component("optimizer", pkg.Adam, lr=3e-3)
    context.add_component("criterion", pkg.HybridLogisticDiceLoss)
    kwargs = dict(
        training_batch_size=2, save_rate=10, scoring_interval=10,
        scoring_function=scoring_function, one_time_evaluators=[],
        training_evaluators=[pkg.ScheduledEvaluation(
            evaluator=pkg.SegmentationEvaluator("y_pred_eval", "y_eval"),
            log_name="training_segmentation_eval", interval=10)],
        validation_evaluators=[pkg.ScheduledEvaluation(
            evaluator=pkg.SegmentationEvaluator("y_pred_eval", "y_eval"),
            log_name="segmentation_eval", cohorts=["validation"], interval=10)],
        max_iterations_with_no_improvement=100,
        train_predictor=pkg.StandardPredict(image_names=["X", "y"], **on_cpu),
        validation_predictor=pkg.StandardPredict(image_names=["X"], **on_cpu),
        train_dataloader_factory=pkg.StandardDataLoader(sampler=getattr(pkg, train_sampler)),
        validation_dataloader_factory=pkg.StandardDataLoader(sampler=pkg.SequentialSampler))
    kwargs.update(trainer_kwargs)
    context.add_component("trainer", pkg.SegmentationTrainer, **kwargs)
    return context


def initial_state():
    """The port's initialization from seed 0 of NestedResUNet(1 -> 2, 4)."""
    model = tsp.SegModel(tsp.NestedResUNet(1, 2, filters=4), device="cpu")
    model.ensure_initialized()
    return {k: v.clone() for k, v in model.module.state_dict().items()}


def record_jax_states(monkeypatch):
    """Make the JAX trainer's steps record the state each one starts from:
    a list of (params, batch_stats, optimizer state) trees of numpy."""
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


def tree_spread(port, ref):
    """||port - ref|| / ||ref||, all tensors taken as one vector."""
    port, ref = (torch.cat([x.reshape(-1).double() for x in v]) for v in (port, ref))
    return float((port - ref).norm() / ref.norm())


def follow_jax(monkeypatch, recorded):
    """Make the port's i-th step start from the JAX run's i-th state: the
    weights, the BatchNorm statistics and Adam's moments and count. First
    hold the state the port carried into step i against that one: within
    STATE_RTOL, and Adam's count exactly (none before the first step)."""
    make = ttrainer.make_train_step

    def following_make(module, *args, **kwargs):
        step = make(module, *args, **kwargs)
        calls = iter(recorded)

        def following_step(state, batch, generator):
            params, batch_stats, opt_state = next(calls)
            adam = opt_state[0]
            weights = flax_to_state_dict({"params": params, "batch_stats": batch_stats})
            mu = flax_to_state_dict({"params": adam.mu})
            nu = flax_to_state_dict({"params": adam.nu})
            live = module.state_dict()
            names = [n for n in weights if not n.endswith("num_batches_tracked")]
            assert tree_spread([live[n] for n in names], [weights[n] for n in names]) \
                <= STATE_RTOL, int(adam.count)
            carried = [state.opt_state.state.get(p, {}) for p in state.params.values()]
            if int(adam.count) == 0:
                assert not any(carried)
            else:
                assert {float(c.get("step", 0)) for c in carried} == {float(adam.count)}
                for key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
                    assert tree_spread([c[key] for c in carried],
                                       [ref[n] for n in state.params]) <= STATE_RTOL, \
                        (int(adam.count), key)
            with torch.no_grad():
                for name, value in weights.items():
                    live[name].copy_(value)
            for name, param in state.params.items():
                state.opt_state.state[param] = {
                    "step": torch.tensor(float(adam.count)),
                    "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
            return step(state, batch, generator)
        return following_step

    monkeypatch.setattr(ttrainer, "make_train_step", following_make)


def run(pkg, root, logs, state, max_iterations=ITERATIONS, seed=0, train_kwargs=None, **kwargs):
    """Build, load ``state`` and train from host seed ``seed`` (with
    ``train_kwargs`` for ``train``); returns the context, the logger and
    the metric records."""
    context = build_context(pkg, root, **kwargs)
    context.init_components()
    context.model.load_state_dict(state if pkg is tsp else state_dict_to_flax(state))
    pkg.seed_all(seed)
    logger = (tsp.FileLogger if pkg is tsp else JFileLogger)(str(logs))
    context.trainer.train(context, max_iterations=max_iterations, logger=logger,
                          **(train_kwargs or {}))
    records = [json.loads(line) for line in open(logger.run_dir / "metrics.jsonl")]
    return context, logger, records


def checkpoint_names(logger):
    return {folder: sorted(p.name for p in (logger.run_dir / folder).iterdir())
            for folder in ("checkpoints", "best_checkpoints")}


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    build_dataset(root)
    state = initial_state()
    with pytest.MonkeyPatch.context() as monkeypatch:
        recorded = record_jax_states(monkeypatch)
        jax_run = run(jsp, root, tmp_path_factory.mktemp("jax-logs"), state)
        assert len(recorded) == ITERATIONS
        follow_jax(monkeypatch, recorded)
        port_run = run(tsp, root, tmp_path_factory.mktemp("port-logs"), state)
    return root, state, jax_run, port_run


def test_losses_match_jax(e2e):
    """Each iteration's losses within 1e-5 of JAX's, relative. The Dice
    loss is one minus a Dice score near one, so it (and the loss it is half
    of) is held to 1e-5 of that unit-sized score: its rounding error is a
    few ulps of 1, whatever the difference's size."""
    _, _, (_, _, jrec), (_, _, trec) = e2e
    assert [r["iteration"] for r in trec] == [r["iteration"] for r in jrec] == \
        list(range(ITERATIONS))
    for j, t in zip(jrec, trec):
        for key, scale in (("loss", 1.0), ("dice_loss", 1.0), ("logistic_loss", 0.0)):
            assert math.isclose(t[key], j[key], rel_tol=LOSS_RTOL, abs_tol=LOSS_RTOL * scale), \
                (j["iteration"], key, t[key], j[key])
    assert np.mean([r["loss"] for r in trec[-3:]]) < np.mean([r["loss"] for r in trec[:3]])


def test_schedule_and_checkpoints_match_jax(e2e):
    """The same evaluators, scores and checkpoint files at the same
    iterations; the timer splits the JAX trainer logs."""
    _, _, (_, jlog, jrec), (context, tlog, trec) = e2e
    assert [sorted(set(t) - {"timer"}) for t in trec] == \
        [sorted(set(j) - {"timer"}) for j in jrec]
    assert [r["iteration"] for r in trec if "segmentation_eval" in r] == [0, 10, 20]
    assert [sorted(t["timer"]) for t in trec] == [sorted(j["timer"]) for j in jrec]
    assert checkpoint_names(tlog) == checkpoint_names(jlog)
    assert sorted(checkpoint_names(tlog)["checkpoints"]) == [
        f"e2e-test-iter{i:08}.ckpt" for i in (0, 10, 20, 21)]
    assert context.trainer.iteration == ITERATIONS
    for name in ("config.json",):
        assert json.load(open(tlog.run_dir / name)).keys() == \
            json.load(open(jlog.run_dir / name)).keys()


def same_logged(port_value, jax_value, where):
    """The logged evaluator outputs: counts equal, ratios to the ten
    significant digits of the JAX package's DataFrame records."""
    if isinstance(jax_value, dict):
        assert port_value.keys() == jax_value.keys(), where
        for k in jax_value:
            same_logged(port_value[k], jax_value[k], f"{where}.{k}")
    elif isinstance(jax_value, list):
        assert len(port_value) == len(jax_value), where
        for i, (p, j) in enumerate(zip(port_value, jax_value)):
            same_logged(p, j, f"{where}[{i}]")
    elif isinstance(jax_value, float):
        assert math.isclose(port_value, jax_value, rel_tol=1e-9), (where, port_value, jax_value)
    else:
        assert port_value == jax_value, where


def test_evaluator_outputs_match_jax(e2e):
    _, _, (_, _, jrec), (_, _, trec) = e2e
    for j, t in zip(jrec, trec):
        for key in ("training_segmentation_eval", "segmentation_eval", "model_score"):
            if key in j:
                same_logged(t[key], j[key], f"iteration {j['iteration']} {key}")
    assert trec[20]["model_score"] > trec[0]["model_score"]


def test_checkpoint_reloads_into_a_fresh_context(e2e):
    """The last checkpoint, loaded by file path on the CPU: the trainer's
    counters and the model's outputs equal the live ones."""
    root, _, _, (context, logger, _) = e2e
    last = sorted((logger.run_dir / "checkpoints").glob("*.ckpt"))[-1]
    restored = tsp.Context("cpu", file_path=str(last), variables={"DATASET_PATH": str(root)})
    restored.keep_components(("model", "dataset", "trainer"))
    restored.init_components()
    assert restored.trainer.iteration == context.trainer.iteration == ITERATIONS
    assert restored.trainer.max_score == context.trainer.max_score
    x = np.random.default_rng(0).normal(size=(1, 1, *SHAPE)).astype(np.float32)
    assert torch.equal(restored.model(x), context.model(x))


def test_resume_repeats_the_uninterrupted_run(e2e, tmp_path):
    """Resumed from the iteration-10 checkpoint (which holds the weights
    after iteration 10's step; the resumed run's iteration 10 is the
    uninterrupted run's 11th), the port repeats the uninterrupted run bit
    for bit: the losses and the last checkpoint's model and optimizer."""
    root, state, _, _ = e2e
    full, full_logger, full_rec = run(tsp, root, tmp_path / "full", state,
                                      train_sampler="SequentialSampler")
    ckpt = full_logger.run_dir / "checkpoints" / "e2e-test-iter00000010.ckpt"
    resumed = tsp.Context("cpu", file_path=str(ckpt), variables={"DATASET_PATH": str(root)})
    resumed.init_components()
    assert resumed.trainer.iteration == 10
    logger = tsp.FileLogger(str(tmp_path / "resumed"))
    resumed.trainer.train(resumed, max_iterations=ITERATIONS - 11, logger=logger)
    rec = [json.loads(line) for line in open(logger.run_dir / "metrics.jsonl")]
    assert [r["loss"] for r in rec] == [r["loss"] for r in full_rec[11:]]
    a = tsp.Context("cpu", file_path=str(full_logger.run_dir / "checkpoints" /
                                         "e2e-test-iter00000020.ckpt"))
    b = tsp.Context("cpu", file_path=str(logger.run_dir / "checkpoints" /
                                         "e2e-test-iter00000020.ckpt"))
    _equal_trees(a.get_component_definition("model")["state_dict"],
                 b.get_component_definition("model")["state_dict"])
    _equal_trees(a.get_component_definition("trainer")["state_dict"]["opt_state"],
                 b.get_component_definition("trainer")["state_dict"]["opt_state"])


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("stop", ["no_improvement", "max_training_time"])
def test_stops_where_jax_stops(e2e, tmp_path, stop):
    """A constant score stops both trainers after
    max_iterations_with_no_improvement; a zero time budget stops both after
    the first iteration. Each writes its exit checkpoint there."""
    root, state, _, _ = e2e
    kwargs = ({"scoring_function": constant_score, "scoring_interval": 1,
               "max_iterations_with_no_improvement": 3} if stop == "no_improvement" else {})
    out = {}
    for pkg in (jsp, tsp):
        context = build_context(pkg, root, **kwargs)
        context.init_components()
        context.model.load_state_dict(state if pkg is tsp else state_dict_to_flax(state))
        pkg.seed_all(0)
        logger = (tsp.FileLogger if pkg is tsp else JFileLogger)(str(tmp_path / pkg.__name__))
        context.trainer.train(context, max_iterations=ITERATIONS, logger=logger,
                              max_training_time=0 if stop == "max_training_time" else None)
        out[pkg] = (context.trainer.iteration, checkpoint_names(logger)["checkpoints"])
    assert out[tsp] == out[jsp]
    assert out[tsp][0] == (4 if stop == "no_improvement" else 0)


def test_async_save_holds_its_own_iteration(e2e, tmp_path, monkeypatch):
    """A FileLogger save taken at iteration k and written on its worker
    thread while more steps run holds iteration k's weights and optimizer
    moments, not the later ones the steps write in place."""
    root, state, _, _ = e2e
    context = build_context(tsp, root)
    context.init_components()
    context.model.load_state_dict(state)
    trainer = context.trainer
    trainer.train(context, max_iterations=2, logger=tsp.NonLogger())
    first = next(context.model.module.parameters())
    expected = {k: v.clone() for k, v in context.model.module.state_dict().items()}
    moments = {k: v.clone() for k, v in trainer._train_state.opt_state.state[first].items()}

    written = threading.Event()
    real_write = tsp.Context.write_snapshot
    more_steps_ran = threading.Event()

    def held_write(checkpoint, filename):
        assert more_steps_ran.wait(timeout=120)
        real_write(checkpoint, filename)
        written.set()

    monkeypatch.setattr(tsp.Context, "write_snapshot", staticmethod(held_write))
    logger = tsp.FileLogger(str(tmp_path))
    logger.setup(context)
    path = logger.save_context(context, "checkpoints/", trainer.iteration)
    trainer.train(context, max_iterations=3, logger=tsp.NonLogger())
    assert not torch.equal(first, expected[next(iter(expected))])
    more_steps_ran.set()
    logger.close()
    assert written.is_set()
    saved = tsp.Context("cpu", file_path=str(path))
    model_state = saved.get_component_definition("model")["state_dict"]
    for k, v in expected.items():
        assert np.array_equal(model_state[k], v.numpy()), k
    opt_state = saved.get_component_definition("trainer")["state_dict"]["opt_state"]
    for k, v in moments.items():
        assert np.array_equal(opt_state["state"][0][k], v.numpy()), k


def test_sync_fetch_and_pretransformed_training_data_match_jax(e2e, tmp_path, monkeypatch):
    """defer_metric_fetch=False (every loss read before the next step; no
    deferred fetch starts) and train(pretransform_training_data=True) (the
    pipeline run once before the loop) on both packages: the same losses
    and records, following JAX's states. A stochastic pipeline warns that
    pretransforming freezes its draw, as in JAX."""
    root, state, _, _ = e2e
    options = dict(train_kwargs={"pretransform_training_data": True}, defer_metric_fetch=False)
    recorded = record_jax_states(monkeypatch)
    _, _, jrec = run(jsp, root, tmp_path / "jax", state, max_iterations=4, **options)
    follow_jax(monkeypatch, recorded)
    fetches = []
    start_fetch = ttrainer.start_fetch
    monkeypatch.setattr(ttrainer, "start_fetch", lambda t: fetches.append(1) or start_fetch(t))
    context, _, trec = run(tsp, root, tmp_path / "port", state, max_iterations=4, **options)
    assert context.trainer.defer_metric_fetch is False and not fetches
    assert "preload_train_s" in context.trainer.startup_phases
    assert [sorted(set(r) - {"timer"}) for r in trec] == [sorted(set(r) - {"timer"}) for r in jrec]
    for j, t in zip(jrec, trec):
        assert math.isclose(t["loss"], j["loss"], rel_tol=LOSS_RTOL, abs_tol=LOSS_RTOL)

    noisy = build_context(tsp, root)
    noisy.get_component_definition("dataset")["params"]["transforms"]["training"] = \
        tsp.Compose([tsp.RandomNoise(std=0.1), noisy.get_component_definition("dataset")[
            "params"]["transforms"]["default"]])
    noisy.init_components()
    with pytest.warns(UserWarning, match="freezes the stochastic transforms"):
        noisy.trainer.train(noisy, max_iterations=1, pretransform_training_data=True)


class Resynthesize(tsp.RandomTransform):
    """A host-only channel resynthesis in the shape of ReconstructMeanDWI:
    it regenerates t1 from itself."""
    mean_dwi_image_name, full_dwi_image_name = "t1", "t1_full"

    def apply_transform(self, subject):
        return subject


def hybrid_training_pipeline():
    """build_context's pipeline behind a resynthesis of t1 and random noise:
    the device augmentation derives to a hybrid split."""
    return tsp.Compose([
        tsp.CopyProperty("t1", "t1_full"),
        Resynthesize(),
        tsp.RandomNoise(std=0.1, p=0.5),
        tsp.Compose([
            tsp.RescaleIntensity((-1, 1), (0.5, 99.5)),
            tsp.ConcatenateImages(image_names=["t1"], image_channels=[1], new_image_name="X"),
            tsp.RenameProperty(old_name="seg", new_name="y"),
            tsp.CustomOneHot(include=["y"]),
        ]),
    ])


@pytest.mark.parametrize("case", ["device_cache", "device_augmentation", "mesh", "spatial_axis",
                                  "refine_image", "device_confusion_sweep"])
def test_what_is_not_ported_raises(e2e, tmp_path, case):
    """spatial_axis raised until item 10b was ported: now a one-rank
    spatial mesh trains through make_spatial_train_step with the
    one-device losses, and like JAX's trainer it needs a mesh and refuses
    the device cache (tests/test_torch_spatial_ranks.py trains 2 ranks);
    mesh raised until
    item 10a was ported: now a one-rank mesh (no process group) trains
    (tests/test_torch_mesh_ranks.py trains 2 ranks). Of the device
    levers, a hybrid split (a host channel resynthesis) raised with the
    device cache until training/hybrid_augment.py was ported: now it trains
    with the cache, whichever lever is set first, through the per-batch host
    stage; without the cache the resynthesis runs inline on the host and
    the device augmentation trains. A refine_image predictor (the cascade)
    and a device-reduced validation sweep raised until their items were
    ported: now the first trains a StochasticMatrix head on a prior (and is
    refused with the device cache, as in JAX) and the second's probe sweep
    turns the device reduction on."""
    root, _, _, _ = e2e

    levers = {"device_cache": True, "device_augmentation": "auto"}
    kwargs = {"device_cache": dict(levers),
              "device_augmentation": dict(reversed(levers.items())),
              "mesh": {"mesh": tsp.make_mesh(device="cpu")},
              "spatial_axis": {"spatial_axis": "w",
                               "mesh": tsp.make_mesh(1, ("w",), device="cpu")},
              "refine_image": {
                  "train_predictor": tsp.StandardPredict(image_names=["X", "y"],
                                                         refine_image="y_prior", device="cpu"),
                  "validation_predictor": tsp.StandardPredict(refine_image="y_prior",
                                                              device="cpu")},
              "device_confusion_sweep": {"validation_predictor": tsp.StandardPredict(
                  image_names=["X"], device_argmax=True, device="cpu")}}[case]

    def context_of(**trainer_kwargs):
        context = build_context(tsp, root, **trainer_kwargs)
        if case in levers:
            context.get_component_definition("dataset")["params"]["transforms"]["training"] = \
                hybrid_training_pipeline()
        if case == "refine_image":
            # the target's one-hot as the prior, a StochasticMatrix head
            context.get_component_definition("dataset")["params"]["transforms"][
                "default"].transforms.append(tsp.CopyProperty("y", "y_prior"))
            context.update_component("model", output_channels=4,
                                     hypothesis_class=tsp.StochasticMatrix,
                                     hypothesis_params={"channels": 2})
        return context

    context = context_of(**kwargs)
    if case in levers:
        context.init_components()
        context.trainer.train(context, max_iterations=1, logger=tsp.NonLogger())
        assert context.trainer._hybrid_rt is not None
        assert context.trainer._hybrid_rt.spec.image_order == ["t1"]
    else:
        context.init_components()
        context.trainer.train(context, max_iterations=1, logger=tsp.NonLogger())
        assert context.trainer.iteration == 1
    if case == "mesh":
        assert context.trainer.mesh.shape == {"data": 1}
        recipe = context.snapshot()["component_definitions"][-1]["params"]["mesh"]
        assert isinstance(recipe, tsp.MeshRecipe) and recipe.shape == (1,)
    if case == "spatial_axis":
        losses = []
        for trainer_kwargs in (kwargs, {}):
            records = []
            logger = tsp.NonLogger()
            logger.log = records.append
            context = context_of(**trainer_kwargs)
            context.init_components()
            tsp.seed_all(0)
            context.trainer.train(context, max_iterations=2, logger=logger)
            losses.append([r["loss"] for r in records if "loss" in r])
        assert len(losses[0]) == 2
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        with pytest.raises(ValueError, match="spatial_axis requires a mesh"):
            context_of(spatial_axis="w").init_components()
        context = context_of(device_cache=True, **kwargs)
        context.init_components()
        with pytest.raises(ValueError, match="device_cache with spatial sharding"):
            context.trainer.train(context, max_iterations=1, logger=tsp.NonLogger())
    if case == "refine_image":
        context = context_of(device_cache=True, **kwargs)
        context.init_components()
        with pytest.raises(ValueError, match="device_cache with a refine_image"):
            context.trainer.train(context, max_iterations=1, logger=tsp.NonLogger())
    if case == "device_confusion_sweep":
        assert context.trainer._confusion_mgr.state == "on"
        context = context_of(device_confusion=False, **kwargs)
        context.init_components()
        context.trainer.train(context, max_iterations=1, logger=tsp.NonLogger())
        assert context.trainer._confusion_mgr is None
    if case == "device_augmentation":
        context = context_of(device_augmentation="auto")
        context.init_components()
        context.trainer.train(context, max_iterations=1, logger=tsp.NonLogger())
        assert context.trainer.resolved_device_augmentation["noise_p"] == 0.5


def test_free_running_float32_adam_parts_beyond_the_tolerance(e2e):
    """Why each port iteration starts from JAX's state: JAX's own train step
    on this fixture, run twice with only the order of the subjects in each
    batch reversed (the same sums in another order), parts by more than
    the 1e-5 tolerance within eight Adam steps. After the first step the
    two runs' weights and Adam moments lie within STATE_RTOL, and the
    weights part by more than a tenth of it: the tolerance ``follow_jax``
    holds the port's carried state to is JAX's own one-step spread."""
    from segmentation_pipeline_tpu.criterions import HybridLogisticDiceLoss as JLoss
    from segmentation_pipeline_tpu.training import optimizers as joptim
    from segmentation_pipeline_tpu.training import train_step as jtrain
    from segmentation_pipeline_tpu.training.model import SegModel as JSegModel

    root, state, _, _ = e2e
    context = build_context(tsp, root)
    context.init_components()
    dataset = context.dataset.get_cohort_dataset("training")
    subjects = [dataset[i] for i in range(len(dataset))]
    optimizer = joptim.Adam(lr=3e-3)
    losses, first_states = [], []
    for order in (subjects, subjects[::-1]):
        batch = {key: np.stack([np.asarray(s[key].data) for s in order]).astype(np.float32)
                 for key in ("X", "y")}
        model = JSegModel(jsp.NestedResUNet(1, 2, filters=4))
        model.load_state_dict(state_dict_to_flax(state))
        train_state = jtrain.create_train_state(model, optimizer, batch)
        step = jtrain.make_train_step(model.module, JLoss(), optimizer)
        device_batch = jtrain.collate_to_device(batch)
        run = []
        for i in range(8):
            train_state, loss_dict, _ = step(train_state, device_batch, jax.random.PRNGKey(i))
            run.append(float(loss_dict["loss"]))
            if i == 0:
                adam = train_state.opt_state[0]
                first_states.append([[torch.from_numpy(np.asarray(x))
                                      for x in jax.tree_util.tree_leaves(tree)]
                                     for tree in (train_state.params, adam.mu, adam.nu)])
        losses.append(np.array(run))
    parted = np.abs(losses[0] - losses[1]) / losses[0]
    print("JAX against itself, batch order reversed, loss rel diff per step:", parted)
    weights, mu, nu = (tree_spread(a, b) for a, b in zip(*first_states))
    print("after one step, weights/mu/nu spread:", weights, mu, nu)
    assert STATE_RTOL / 10 < weights <= STATE_RTOL and mu <= STATE_RTOL and nu <= STATE_RTOL
    assert parted[0] < LOSS_RTOL and parted.max() > LOSS_RTOL


def test_trainer_defaults_to_cuda(e2e, monkeypatch):
    """The context's model goes to the card unless the context says
    otherwise; without a GPU that raises."""
    root, _, _, _ = e2e
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    context = build_context(tsp, root)
    context.device = None
    with pytest.raises(RuntimeError, match="CUDA"):
        context.init_components()
    assert ttrainer.is_exact_onehot(np.eye(3)[[0, 2, 1]].T[None])
    assert not ttrainer.is_exact_onehot(np.full((1, 2, 3), 0.5))
