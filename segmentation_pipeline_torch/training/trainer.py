"""SegmentationTrainer: the scheduled-evaluation training loop.

Ported from segmentation_pipeline_tpu/training/trainer.py: iteration-based
training with interval-scheduled evaluators over named cohorts, model
scoring and best-checkpoint tracking, early stopping,
a wall-clock budget with a save buffer, and cooperative
SIGINT/SIGTERM/SIGUSR2 preemption, around the eager train step of
training/train_step.py. The device levers of the configurations'
``tpu_fast_path``: ``device_cache`` (the training set pretransformed once
and uploaded; batches are gathers, or patches drawn, on the device) and
``device_augmentation`` (ops/augment.py on each batch before the step; a
config dict, or "auto" to derive it from the declared pipeline,
training/auto_augment.py). A train predictor with ``refine_image`` (the
cascade) ships that image of each batch (the prior) beside X and y, and
the step contracts the model's transition matrices with it. A validation
sweep that only needs counts (a ``device_argmax`` predictor with only
Segmentation and InstanceSegmentation evaluators) is reduced on the device
once a probe sweep has held it to the host chain, exactly
(training/device_confusion.py; ``device_confusion=False`` keeps the host
path).

The host work runs in the JAX package's order, so a seeded run draws the
same host randomness there and here: ``training_dataset[0]`` before the
loop, the first batch before the first step, the next batch after each
step, then the evaluators. One-hot labels ship as uint8 class ids and expand
on the device; under bfloat16 the input is cast on the host first. Both go
through pinned memory without blocking the host, so the next batch uploads
while the step runs. On iterations with nothing scheduled the loss values
are read one iteration late, from a copy that waits only for their own step
(``defer_metric_fetch=False`` reads them every iteration).
Each iteration is a ``trainer.iteration`` span (utils/timer.py) whose
children name its phases: the fetch, the augmentation, the step's dispatch,
the loss read (where the host waits for the step), the evaluations, the
sweep, the checkpoints and the logging. The log record's ``timer`` holds
the seconds of those phases under the JAX package's keys.
Dropout, device patch sampling and device augmentation draw from one
``torch.Generator`` on the model's device, seeded from the iteration the
run starts at.

With a ``mesh`` (parallel/mesh.py, one process per device) the trainer
trains data-parallel: every rank runs the same host code from the same
seed, so every rank loads, or gathers from its replica of the device cache,
the same global batch and draws the same augmentation, and keeps its rows;
the step (training/train_step.py) sums the gradients of the global batch.
The JAX package's single controller writes each checkpoint and log record
once: here rank 0 writes them and the other ranks compute the same values
and skip the writes. Scheduled training evaluators see the global batch's
predictions, gathered from the ranks. Each iteration the ranks vote on
stopping (the time budget, a stop signal), so all stop at one iteration.

With a ``spatial_axis`` the mesh also shards W: each host-loaded batch of
whole volumes ships in float32 and one-hot, each rank takes its slab of W
(and its rows over the mesh's 'data' axis where that axis is wider than 1)
and the step is training/train_step.py::make_spatial_train_step. Scheduled
training evaluators see the whole prediction, gathered from the slabs. As
in the JAX package, spatial sharding refuses the device augmentation and
the device cache.
"""
from __future__ import annotations

import copy
import math
import os
import random
import signal
import sys
import threading
import time
import traceback
import warnings
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..data.device_cache import is_exact_onehot
from ..data.loader import DataLoaderFactory
from ..data.subject_filters import AnyFilter, RequireAttributes
from ..evaluators import Evaluator
from ..loggers import Logger, NonLogger
from ..ops.bitpack import start_fetch
from ..parallel.mesh import BatchShard, all_gather_rows, any_rank, gather_w
from ..prediction import Predictor, _attach_prediction, add_evaluation_labels
from ..utils.misc import auto_str, time_str_to_seconds
from ..utils.timer import Timer, span
from .model import to_channels_first
from .train_step import (TrainState, _normalize_compute_dtype, collate_to_device,
                         create_train_state, make_spatial_train_step, make_train_step)

EXIT = threading.Event()
EXIT.clear()


def _clean_exit_handler(signum, frame):
    EXIT.set()
    print("Exiting cleanly", flush=True)


def install_signal_handlers():
    """SIGINT/SIGTERM/SIGUSR2 -> clean-exit event (SLURM preemption). Safe
    to call from the main thread only; the trainer calls it lazily. Returns
    {signum: previous handler} so train() can restore them on exit."""
    previous = {}
    previous[signal.SIGINT] = signal.signal(signal.SIGINT, _clean_exit_handler)
    previous[signal.SIGTERM] = signal.signal(signal.SIGTERM, _clean_exit_handler)
    if os.name != "nt":
        previous[signal.SIGUSR2] = signal.signal(signal.SIGUSR2, _clean_exit_handler)
    return previous


def restore_signal_handlers(previous):
    for signum, handler in (previous or {}).items():
        try:
            signal.signal(signum, handler)
        except (ValueError, TypeError):  # non-main thread / exotic handler
            pass


class ScheduledEvaluation:
    def __init__(self, evaluator: Evaluator, log_name: str,
                 cohorts: Sequence[str] = None, subjects: Sequence[str] = None,
                 interval: int = 1):
        assert not (cohorts and subjects), \
            "One of cohorts or subjects may be provided, but not both."
        self.evaluator = evaluator
        self.log_name = log_name
        self.cohorts = cohorts
        self.subjects = subjects
        self.interval = interval

    def __repr__(self):
        return auto_str(self)


def stack_batch(subjects, compute_dtype=None):
    """X and y of a batch of subjects as the trainer ships them: X stacked
    channel-first as float32 and cast on the host to ``compute_dtype``
    (numpy has no bfloat16, so X is a torch tensor); y as uint8 class ids
    (N, W, H, D) when it is exactly one-hot, else float32 (N, C, W, H, D).
    Returns the host batch and the number of classes of the ids (None for
    float y)."""
    X = np.stack([np.asarray(s["X"].data) for s in subjects]).astype(np.float32)
    y = np.stack([np.asarray(s["y"].data) for s in subjects]).astype(np.float32)
    x = torch.from_numpy(X)
    dtype = _normalize_compute_dtype(compute_dtype)
    if dtype is not None:
        x = x.to(dtype)  # the rounding the step's own cast applies
    n_classes = None
    if is_exact_onehot(y, axis=1):
        n_classes = y.shape[1]
        y = np.argmax(y, axis=1).astype(np.uint8)
    return {"X": x, "y": y}, n_classes


def expand_ids(batch, n_classes):
    """On the device: (N, W, H, D) class ids -> (N, W, H, D, C) float32
    one-hot; other labels stay as they are."""
    if batch["y"].dim() == 4:
        batch["y"] = F.one_hot(batch["y"].long(), n_classes).float()
    return batch


def upload_batch(batch_cf, n_classes, device, mesh=None):
    """A host batch of ``stack_batch`` to the device, channels-last
    (``collate_to_device``: pinned, without blocking the host; on a mesh
    this rank's rows), class ids expanded there to float32 one-hot."""
    batch = collate_to_device(batch_cf, device=device, mesh=mesh)
    return batch if n_classes is None else expand_ids(batch, n_classes)


def _to_torch(value):
    """A checkpoint's host copies back to tensors (new memory)."""
    if isinstance(value, np.ndarray):
        return torch.tensor(value)
    if isinstance(value, dict):
        return {k: _to_torch(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_torch(v) for v in value)
    return value


class SegmentationTrainer:
    def __init__(self, training_batch_size: int, save_rate: int,
                 scoring_interval: int, scoring_function: Callable,
                 one_time_evaluators: Sequence[ScheduledEvaluation],
                 training_evaluators: Sequence[ScheduledEvaluation],
                 validation_evaluators: Sequence[ScheduledEvaluation],
                 max_iterations_with_no_improvement: int,
                 train_predictor: Predictor, validation_predictor: Predictor,
                 train_dataloader_factory: DataLoaderFactory,
                 validation_dataloader_factory: DataLoaderFactory,
                 mesh=None, device_augmentation: Optional[dict] = None,
                 spatial_axis: Optional[str] = None,
                 compute_dtype: Optional[str] = None,
                 device_cache: bool = False,
                 defer_metric_fetch: bool = True,
                 device_confusion: Optional[bool] = None):
        if isinstance(device_augmentation, str) and device_augmentation != "auto":
            raise ValueError(
                f"device_augmentation={device_augmentation!r}: pass a config "
                f"dict, {{}} for defaults, None, or 'auto'")
        if spatial_axis is not None and mesh is None:
            raise ValueError("spatial_axis requires a mesh")
        self.training_batch_size = training_batch_size
        self.save_rate = save_rate
        self.scoring_interval = scoring_interval
        self.scoring_function = scoring_function
        # stored but never executed, as in the JAX package
        self.one_time_evaluators = one_time_evaluators
        self.training_evaluators = training_evaluators
        self.validation_evaluators = validation_evaluators
        self.max_iterations_with_no_improvement = max_iterations_with_no_improvement
        self.train_predictor = train_predictor
        self.validation_predictor = validation_predictor
        self.train_dataloader_factory = train_dataloader_factory
        self.validation_dataloader_factory = validation_dataloader_factory
        # data-parallel training over a parallel.mesh.Mesh (one process per
        # device); None trains on the model's device alone
        self.mesh = mesh
        # spatially sharded training: each volume's W axis sharded over this
        # mesh axis, through make_spatial_train_step; the mesh's 'data' axis
        # (where it is wider than 1) shards the batch on top
        self.spatial_axis = spatial_axis
        # mixed precision: the network runs forward and backward in this
        # dtype ('bfloat16'); parameters, optimizer state, BatchNorm
        # statistics and the loss stay float32. A string keeps the trainer
        # definition picklable in checkpoints.
        self.compute_dtype = compute_dtype
        # ops/augment.py on each training batch before the step: a config
        # dict ({} for the defaults), or "auto" to derive it from the
        # training cohort's declared pipeline (training/auto_augment.py),
        # whose deterministic prefix and suffix stay on the host
        self.device_augmentation = device_augmentation
        # the training set pretransformed once (its pipeline must then be
        # deterministic) and uploaded; batches become gathers, or patch
        # draws, on the device (data/device_cache.py)
        self.device_cache = device_cache
        # True: an iteration with no scheduled evaluator, checkpoint or
        # scoring reads its loss values one iteration late, so the fetch
        # overlaps the next step (the values are the same); False: every
        # iteration reads them before the next one starts
        self.defer_metric_fetch = defer_metric_fetch
        # None/True: a sweep that only needs counts is reduced on the device
        # once the probe sweep has matched the host chain; False: the host
        # path always
        self.device_confusion = device_confusion

        self.iteration = 0
        self.max_score = float("-inf")
        self.max_score_iteration = -1
        self._train_state: Optional[TrainState] = None
        self._restored_opt_state = None
        # (iteration, "host" | "probe" | "on", seconds) of each validation
        # sweep's predictions, reductions and probe check
        self.sweep_times = []

    def _spatial_data_axis(self) -> Optional[str]:
        """The batch axis beside spatial sharding: the mesh's 'data' axis
        where it exists wider than 1."""
        if self.mesh is not None and self.mesh.shape.get("data", 1) > 1:
            return "data"
        return None

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of a step's per-rank part (channels-last): W
        slabs joined over the spatial axis, rows over the batch axis."""
        mesh = self.mesh
        if mesh is None:
            return x
        if self.spatial_axis is None:
            return all_gather_rows(x, mesh)
        x = gather_w(x, mesh, self.spatial_axis, dim=1)
        data_axis = self._spatial_data_axis()
        return x if data_axis is None else all_gather_rows(x, mesh, data_axis)

    # ---- checkpoint state ---------------------------------------------
    def state_dict(self):
        """Live references: Context.snapshot takes the host copies."""
        state = {
            "iteration": self.iteration,
            "max_score": self.max_score,
            "max_score_iteration": self.max_score_iteration,
        }
        if self._train_state is not None:
            state["opt_state"] = self._train_state.opt_state.state_dict()
        return state

    def load_state_dict(self, state):
        self.iteration = state["iteration"]
        self.max_score = state["max_score"]
        self.max_score_iteration = state["max_score_iteration"]
        # loaded into the torch optimizer at the first step
        self._restored_opt_state = state.get("opt_state")

    def _optimizer_for(self, model, optimizer):
        """The torch optimizer of this run: a checkpoint's state loaded into
        a fresh one, else the live one of a previous train() call while it
        still steps this model's parameters, else a fresh one."""
        params = list(model.params.values())
        live = self._train_state.opt_state if self._train_state is not None else None
        if self._restored_opt_state is None and live is not None:
            live_params = [p for group in live.param_groups for p in group["params"]]
            if optimizer.made(live) and len(live_params) == len(params) \
                    and all(a is b for a, b in zip(live_params, params)):
                return live
            print("trainer: optimizer/param structure changed since the previous train() "
                  "call — reinitializing optimizer state")
        opt = create_train_state(model, optimizer, None).opt_state
        if self._restored_opt_state is not None:
            opt.load_state_dict(_to_torch(self._restored_opt_state))
            self._restored_opt_state = None
        return opt

    # ---- training ------------------------------------------------------
    def train(self, context, max_iterations: int = None,
              max_training_time: Optional[Union[int, str]] = None,
              preload_training_data: bool = False,
              pretransform_training_data: bool = False,
              preload_validation_data: bool = False,
              num_workers: int = 0, validation_batch_size: int = 16,
              logger: Logger = None, force_continue: bool = False):
        """Train until ``max_iterations``, the time budget, early stopping
        or a stop signal. ``pretransform_training_data`` runs the training
        pipeline once over the loaded subjects before the first iteration,
        so each batch is only copied and collated (a stochastic transform
        then keeps its one draw, which a warning says; pair it with
        ``device_augmentation``). ``force_continue`` forgets the best score so far,
        so a run that early stopping ended trains on; the optimizer's live
        state (moments, an accumulation's counters and gradients) carries
        over from a previous call in the process, as in the JAX package."""
        logger = logger or NonLogger()
        mesh = self.mesh
        spatial_axis = self.spatial_axis
        if mesh is not None:
            data_axis = self._spatial_data_axis() if spatial_axis else mesh.data_axis
            shards = 1 if data_axis is None else mesh.shape[data_axis]
            if self.training_batch_size % shards:
                raise ValueError(f"training_batch_size={self.training_batch_size} does not "
                                 f"split over the {shards} ranks of the mesh's batch axis")
            if mesh.rank != 0:
                # rank 0 writes the checkpoints and the log records
                logger = NonLogger()
        # a previous signal-stopped run must not stop this one
        EXIT.clear()
        prev_signal_handlers = None
        if threading.current_thread() is threading.main_thread():
            prev_signal_handlers = install_signal_handlers()

        if max_training_time is not None:
            training_time = time_str_to_seconds(max_training_time)
            save_buffer = min(int(training_time * 0.1), 5 * 60)
            stop_time = time.time() + training_time - save_buffer
        else:
            stop_time = math.inf

        if force_continue:
            self.max_score = float("-inf")
            self.max_score_iteration = self.iteration

        print("Initializing logger.")
        logger.setup(context)

        phases = self.startup_phases = {}
        training_dataset = context.dataset.get_cohort_dataset("training")
        device_aug, probe_subject = self._resolve_device_augmentation(training_dataset)

        # device_cache pretransforms the training set once: a still
        # stochastic host pipeline would bake one random draw into the
        # cache for the whole run
        if self.device_cache:
            from .auto_augment import contains_random

            if not training_dataset._pretransformed \
                    and contains_random(training_dataset.transform):
                raise ValueError(
                    "device_cache=True pretransforms the training set once, "
                    "which would FREEZE the stochastic transforms in the "
                    "training pipeline into a single draw baked into the cache. "
                    "Pass device_augmentation='auto' to map them onto the "
                    "device pipeline (training/auto_augment.py), or "
                    "strip them from the cohort transform explicitly.")

        if preload_training_data or pretransform_training_data:
            t = time.time()
            print("Preloading training data...")
            if pretransform_training_data:
                from .auto_augment import contains_random

                if contains_random(training_dataset.transform):
                    warnings.warn(
                        "pretransform_training_data=True freezes the stochastic transforms in "
                        "the training pipeline into a single draw. Pass "
                        "device_augmentation='auto' to keep augmenting per step on the device.")
                training_dataset.preload_and_transform_subjects()
            else:
                training_dataset.preload_subjects()
            phases["preload_train_s"] = round(time.time() - t, 2)
            print(f"Done. Took {phases['preload_train_s']}s")

        for scheduled in self.validation_evaluators:
            if scheduled.cohorts is None and scheduled.subjects is None:
                raise ValueError(
                    f"Validation evaluator {scheduled.log_name!r} needs cohorts= or "
                    f"subjects= — with neither it would silently never run (training "
                    f"evaluators may omit both; they evaluate the current batch)")
        validation_filter = self.get_filter_from_scheduled_evaluations(
            context.dataset, self.validation_evaluators)
        validation_dataset = context.dataset.get_cohort_dataset(validation_filter)
        if preload_validation_data:
            t = time.time()
            print("Preloading validation data...")
            validation_dataset.preload_and_transform_subjects()
            print(f"Done. Took {round(time.time() - t, 2)}s")
            # static subjects: the predictor may keep their device uploads
            if getattr(self.validation_predictor, "cache_inputs", False) is None:
                self.validation_predictor.cache_inputs = True

        training_iterator = None
        if not self.device_cache:
            training_dataloader = self.train_dataloader_factory.get_data_loader(
                dataset=training_dataset, batch_size=self.training_batch_size,
                num_workers=num_workers)

            def infinite(loader):
                while True:
                    yield from loader

            training_iterator = infinite(training_dataloader)

        # label attributes for wrapping raw predictions as LabelMaps (the
        # auto-augmentation's spacing probe when it ran)
        sample = probe_subject if probe_subject is not None else training_dataset[0]
        label_attributes = dict(sample["y"].metadata)

        # the run's device-confusion state machine (probe -> on or off)
        confusion_mgr = None
        if self.device_confusion is not False:
            from .device_confusion import DeviceConfusionManager

            confusion_mgr = DeviceConfusionManager(label_attributes)
        self._confusion_mgr = confusion_mgr  # exposed: its state, its counters

        model = context.model
        # validation sweeps run through the predictors, which honor
        # model.compute_dtype: keep them in the training step's precision
        # (an explicit model setting wins)
        if self.compute_dtype is not None \
                and getattr(model, "compute_dtype", "absent") is None:
            model.compute_dtype = self.compute_dtype
        criterion = context.criterion
        optimizer = context.optimizer
        sagittal_split = getattr(self.train_predictor, "sagittal_split", False)

        refine_image = getattr(self.train_predictor, "refine_image", None)
        if refine_image is not None and device_aug is not None:
            raise ValueError(
                "device_augmentation with a refine_image (cascade) predictor is not supported: "
                "geometric augmentation would misalign the prior; augment in the host "
                "pipeline instead")
        if refine_image is not None and self.device_cache:
            raise ValueError(
                "device_cache with a refine_image (cascade) predictor is not supported: the "
                "prior is prediction-dependent")
        if spatial_axis is not None and device_aug is not None:
            raise ValueError(
                "device_augmentation with spatial_axis (W-sharded volumes) is not supported: "
                "the warp gathers at computed indices across the whole volume, which is what "
                "spatial sharding exists to avoid. Augment in the host pipeline, or drop "
                "spatial_axis")
        if spatial_axis is not None and self.device_cache:
            raise ValueError("device_cache with spatial sharding is not supported")

        train_step = None
        timer = Timer()
        generator = torch.Generator(device=model.device).manual_seed(self.iteration)
        max_iterations = int(max_iterations if max_iterations is not None else 10 ** 9)

        # the number of classes of one-hot labels that travel as uint8 ids
        # until the augmentation has warped them
        compact = {"n_classes": None}
        cache, index_iterator = None, None
        if self.device_cache:
            cache, index_iterator = self._build_cache(
                training_dataset, device_aug, model.device, phases, mesh)
            if cache._is_onehot and device_aug is not None:
                compact["n_classes"] = cache.n_classes
        self._cache = cache  # exposed for measurements: its bytes, a sample() to time

        def fetch_and_upload():
            """Pull the next batch (a device gather or patch draw from the
            cache, else the host pipeline's, whose upload starts here).
            Called while the device runs the current step, so the upload
            rides under it."""
            if cache is not None:
                return self._fetch_cached(cache, next(index_iterator), training_dataset,
                                          generator)
            subjects = next(training_iterator)
            if spatial_axis is not None:
                # whole volumes in float32 and one-hot; each rank its slab
                return subjects, collate_to_device(
                    {key: np.stack([np.asarray(s[key].data) for s in subjects]).astype(
                        np.float32) for key in ("X", "y")},
                    mesh=mesh, data_axis=self._spatial_data_axis(), spatial_axis=spatial_axis)
            batch_cf, n_classes = stack_batch(subjects, self.compute_dtype)
            if refine_image is not None:
                # the cascade's prior rides along for the step's refinement
                batch_cf[refine_image] = np.stack(
                    [np.asarray(s[refine_image].data) for s in subjects]).astype(np.float32)
            if device_aug is None:
                return subjects, upload_batch(batch_cf, n_classes, model.device, mesh)
            # the device augmentation warps class ids and expands them after
            compact["n_classes"] = n_classes
            return subjects, collate_to_device(batch_cf, device=model.device, mesh=mesh)

        pending = None  # (subjects, device batch) prefetched last iteration
        deferred = None  # the loss record of a logging-only iteration

        def flush_deferred():
            nonlocal deferred
            if deferred is None:
                return
            with timer.phase("train_step", "trainer.read_loss", wait=True):
                vals = deferred["fetch"]()
            rec = {k: float(v) for k, v in zip(deferred["keys"], vals)}
            rec["timer"] = deferred["timer"]
            rec["iteration"] = deferred["iteration"]
            with span("trainer.log"):
                logger.log(rec)
            deferred = None

        try:
            for _ in range(max_iterations):
                timer.start()
                with span("trainer.iteration", iteration=self.iteration):
                    if pending is None:  # nothing prefetched: the first iteration
                        with timer.phase("data_loading", "trainer.fetch", prefetch=False):
                            pending = fetch_and_upload()
                    else:
                        timer.timestamps["data_loading"] = 0.0
                    subjects, batch = pending

                    if train_step is None:
                        with timer.phase("train_step", "trainer.build_step"):
                            model.ensure_initialized()
                            self._train_state = TrainState(
                                step=self.iteration, params=model.params,
                                batch_stats=model.batch_stats,
                                opt_state=self._optimizer_for(model, optimizer))
                            if spatial_axis is not None:
                                train_step = make_spatial_train_step(
                                    model.module, criterion, optimizer, mesh,
                                    spatial_axis=spatial_axis,
                                    data_axis=self._spatial_data_axis(),
                                    compute_dtype=self.compute_dtype)
                            else:
                                train_step = make_train_step(
                                    model.module, criterion, optimizer, mesh=mesh,
                                    sagittal_split=sagittal_split,
                                    compute_dtype=self.compute_dtype,
                                    refine_image=refine_image)

                    if device_aug is not None:
                        from ..ops.augment import augment_batch

                        with timer.phase("train_step", "trainer.augment"):
                            shard = None if mesh is None else BatchShard.of(
                                mesh, batch["X"].shape[0] * mesh.data_size)
                            batch["X"], batch["y"] = augment_batch(
                                generator, batch["X"], batch["y"], config=device_aug,
                                shard=shard)
                            batch = expand_ids(batch, compact["n_classes"])  # after the warp
                    with timer.phase("train_step", "trainer.step"):
                        self._train_state, loss_dict, y_pred_cl = train_step(
                            self._train_state, batch, generator)

                    # while the step runs on the device, load and upload the next batch
                    with timer.phase("next_batch_prefetch", "trainer.fetch", prefetch=True):
                        try:
                            pending = fetch_and_upload()
                        except StopIteration:  # infinite iterator in practice
                            pending = None

                    loss_keys = list(loss_dict)
                    loss_stack = torch.stack([loss_dict[k] for k in loss_keys])

                    # last iteration's deferred record first: its step has ended
                    # or ends while this one queues
                    flush_deferred()

                    scheduled_train = [s for s in self.training_evaluators
                                       if self.iteration % s.interval == 0]
                    scheduled_validation = [s for s in self.validation_evaluators
                                            if self.iteration % s.interval == 0]
                    # a logging-only iteration reads its loss values one iteration
                    # late (the values are identical; only when the host reads
                    # them changes)
                    busy = (
                        not self.defer_metric_fetch
                        or bool(scheduled_train)
                        or bool(scheduled_validation)
                        or self.iteration % self.save_rate == 0
                        or (self.scoring_function is not None
                            and self.iteration % self.scoring_interval == 0))
                    if not busy:
                        # logging-only iteration: read the values next iteration
                        deferred = {"keys": loss_keys, "fetch": start_fetch(loss_stack),
                                    "timer": dict(timer.timestamps),
                                    "iteration": self.iteration}
                    else:
                        # the read waits for the step: the device's time lands here
                        with timer.phase("train_step", "trainer.read_loss", wait=True):
                            loss_vals = loss_stack.cpu().numpy()
                        loss_dict = {k: float(v) for k, v in zip(loss_keys, loss_vals)}

                    # scheduled training evaluators see the train-mode predictions
                    training_evaluations = {}
                    if scheduled_train:
                        with span("trainer.train_eval"):
                            first = f"evaluation.{scheduled_train[0].log_name}"
                            with timer.phase(first, "trainer.train_eval.read", wait=True):
                                # the global batch's predictions, on a mesh gathered
                                y_pred_cf = to_channels_first(
                                    self._gathered(y_pred_cl)).cpu().numpy()
                                if device_aug is not None:
                                    # the prediction lives in the augmented geometry:
                                    # the evaluators compare it with the augmented
                                    # target
                                    y_aug_cf = to_channels_first(
                                        self._gathered(batch["y"])).cpu().numpy()
                            with timer.phase(first, "trainer.train_eval.attach"):
                                if callable(subjects):  # the cache's lazy batch subjects
                                    subjects = subjects()
                                for i, subject in enumerate(subjects):
                                    if device_aug is not None and "y" in subject:
                                        subject["y"].set_data(y_aug_cf[i].astype(
                                            np.asarray(subject["y"].data).dtype))
                                    _attach_prediction(subject, y_pred_cf[i], label_attributes)
                                add_evaluation_labels(subjects)
                            for scheduled in scheduled_train:
                                with timer.phase(f"evaluation.{scheduled.log_name}",
                                                 "trainer.train_eval.evaluate",
                                                 evaluator=scheduled.log_name):
                                    training_evaluations[scheduled.log_name] = \
                                        scheduled.evaluator(subjects)

                    # scheduled validation sweep
                    validation_evaluations = {}
                    if scheduled_validation:
                        with timer.phase("model_forward_evaluation", "trainer.sweep"):
                            t_sweep = time.perf_counter()
                            validation_filter = self.get_filter_from_scheduled_evaluations(
                                context.dataset, scheduled_validation)
                            validation_dataset.set_cohort(validation_filter)
                            validation_loader = iter(
                                self.validation_dataloader_factory.get_data_loader(
                                    dataset=validation_dataset,
                                    batch_size=validation_batch_size,
                                    num_workers=num_workers))
                            use_dev_confusion = False
                            if confusion_mgr is not None and confusion_mgr.state != "off":
                                from .device_confusion import sweep_spec

                                spec = sweep_spec(scheduled_validation,
                                                  self.validation_predictor)
                                use_dev_confusion = spec is not None
                                if use_dev_confusion:
                                    confusion_mgr.configure_sweep(spec)
                            probe_sweep = use_dev_confusion and confusion_mgr.state == "probe"
                            sweep_state = confusion_mgr.state if use_dev_confusion else "host"
                            validation_subjects = []
                            while True:
                                with span("trainer.sweep.load", wait=True):
                                    val_subjects = next(validation_loader, None)
                                if val_subjects is None:
                                    break
                                if use_dev_confusion:
                                    self.validation_predictor._confusion_plan = confusion_mgr
                                try:
                                    val_subjects, _ = self.validation_predictor.predict(
                                        model, val_subjects, label_attributes=label_attributes)
                                finally:
                                    self.validation_predictor._confusion_plan = None
                                # subjects reduced on the device carry no prediction
                                # to invert
                                add_evaluation_labels([s for s in val_subjects
                                                       if "y_pred" in s])
                                validation_subjects += val_subjects
                            if probe_sweep:
                                # the probe sweep ran both paths: the device
                                # reduction goes on only if its counts equal the
                                # host chain's (and unchecked entries are stripped
                                # before the evaluators read them)
                                with span("trainer.sweep.probe"):
                                    confusion_mgr.validate_probe(validation_subjects)
                            self.sweep_times.append((self.iteration, sweep_state,
                                                     time.perf_counter() - t_sweep))
                            validation_subjects_map = {s["name"]: s for s in validation_subjects}

                        with span("trainer.val_eval"):
                            for scheduled in scheduled_validation:
                                if scheduled.cohorts is not None:
                                    cohort_evaluations = {}
                                    validation_evaluations[scheduled.log_name] = \
                                        cohort_evaluations
                                    for cohort_name in scheduled.cohorts:
                                        with timer.phase(
                                                f"evaluation.{scheduled.log_name}.{cohort_name}",
                                                "trainer.val_eval.evaluate",
                                                evaluator=scheduled.log_name, cohort=cohort_name):
                                            subject_filter = validation_dataset.cohorts[cohort_name]
                                            filtered = subject_filter(validation_subjects)
                                            # always produce the cohort key: scoring
                                            # functions index it
                                            cohort_evaluations[cohort_name] = \
                                                scheduled.evaluator(filtered)
                                elif scheduled.subjects is not None:
                                    with timer.phase(f"evaluation.{scheduled.log_name}",
                                                     "trainer.val_eval.evaluate",
                                                     evaluator=scheduled.log_name):
                                        filtered = [validation_subjects_map[name]
                                                    for name in scheduled.subjects]
                                        validation_evaluations[scheduled.log_name] = \
                                            scheduled.evaluator(filtered)

                    if busy:
                        log_dict = {**loss_dict, **training_evaluations,
                                    **validation_evaluations}

                    if self.iteration % self.save_rate == 0:
                        with timer.phase("save_checkpoint", "trainer.checkpoint"):
                            logger.save_context(context, "checkpoints/", self.iteration)

                    # scoring_function=None disables scoring, best-checkpoint
                    # tracking and score-based early stopping
                    if (self.scoring_function is not None
                            and self.iteration % self.scoring_interval == 0):
                        with span("trainer.log", scoring=True):
                            new_score = float(self.scoring_function(log_dict))
                        log_dict["model_score"] = new_score
                        if new_score > self.max_score:
                            self.max_score = new_score
                            self.max_score_iteration = self.iteration
                            with timer.phase("save_best_checkpoint", "trainer.checkpoint",
                                             best=True):
                                logger.save_context(context, "best_checkpoints/",
                                                    self.iteration)

                    if busy:
                        log_dict["timer"] = dict(timer.timestamps)
                        log_dict["iteration"] = self.iteration
                        with span("trainer.log"):
                            logger.log(log_dict)

                    iterations_with_no_improvement = self.iteration - self.max_score_iteration
                    if (self.scoring_function is not None and
                            iterations_with_no_improvement
                            > self.max_iterations_with_no_improvement):
                        print(f"Training stopped on iteration {self.iteration} due to not "
                              f"improving for {iterations_with_no_improvement} iterations.")
                        break

                    signalled, expired = EXIT.is_set(), time.time() > stop_time
                    # on a mesh the ranks start, and take a signal, apart: they
                    # stop at the same iteration, or one would wait for the
                    # others in the next step's collectives
                    if any_rank(signalled or expired, mesh):
                        if signalled:
                            print("Training stopped early due to manual exit signal.")
                        elif expired:
                            print("Training time expired.")
                        else:
                            print("Training stopped with another rank of the mesh.")
                        break

                    self.iteration += 1

            flush_deferred()
            print("Saving context...")
            logger.save_context(context, "checkpoints/", self.iteration)
        finally:
            # hand the process's signal handling back
            restore_signal_handlers(prev_signal_handlers)
            # drain pending checkpoint writes: the exit checkpoint must be
            # durable when train() returns. Duck-typed loggers may not
            # define close().
            close = getattr(logger, "close", None)
            if close is not None:
                # sampled here: inside the except below it would be the
                # close failure
                unwinding = sys.exc_info()[0] is not None
                try:
                    close()
                except Exception:
                    if not unwinding:
                        raise
                    # never mask the training exception with a teardown failure
                    print("Warning: logger close failed while handling an earlier error:",
                          flush=True)
                    traceback.print_exc()

    def _resolve_device_augmentation(self, training_dataset):
        """The device-augmentation config of this run, and the spacing probe
        subject when one was transformed. "auto" derives the config from the
        cohort's declared pipeline and leaves the deterministic remainder
        on the dataset; a second train() in the process reuses the first
        resolution (re-deriving from the remainder would find no
        randomness). Exposed as ``resolved_device_augmentation``; a
        hybrid split for the device cache (a per-batch host stage,
        training/hybrid_augment.py) as ``_resolved_hybrid_spec``."""
        device_aug, probe_subject, hybrid_spec = self.device_augmentation, None, None
        if device_aug == "auto" and training_dataset.transform is getattr(
                self, "_auto_aug_host_transform", object()):
            device_aug = self.resolved_device_augmentation
            hybrid_spec = getattr(self, "_resolved_hybrid_spec", None)
        elif device_aug == "auto":
            from .auto_augment import derive_hybrid_augmentation, describe_config

            declared = training_dataset.transform
            host_t, aug_cfg, hybrid_spec = derive_hybrid_augmentation(declared)
            if aug_cfg is None and hybrid_spec is None:
                print("device_augmentation='auto': the training pipeline declares no "
                      "stochastic transforms; device augmentation disabled.")
                device_aug = None
            else:
                if hybrid_spec is not None and not self.device_cache:
                    # no cached batch to splice into: the peeled host stage
                    # runs inline, the derived window on the device
                    host_t = hybrid_spec.host_inline
                    hybrid_spec = None
                training_dataset.set_transform(host_t)
                self._auto_aug_host_transform = host_t
                # blur and elastic are in mm on the host: convert with the
                # spacing at the augmentation point, from one transformed sample
                if aug_cfg is not None and (
                        aug_cfg.get("blur_p", 0) or aug_cfg.get("elastic_p", 0)
                        or aug_cfg.get("spatial_mode") == "oneof"):
                    probe_subject = training_dataset[0]
                    spacing = tuple(float(s) for s in probe_subject["X"].spacing)
                    _, aug_cfg, _ = derive_hybrid_augmentation(declared, spacing)
                device_aug = aug_cfg
                msg = (describe_config(aug_cfg) if aug_cfg is not None
                       else "(all device stages off)")
                if hybrid_spec is not None:
                    msg += f" + per-batch host stage {hybrid_spec}"
                print(f"device_augmentation='auto': {msg}")
        self.resolved_device_augmentation = device_aug
        self._resolved_hybrid_spec = hybrid_spec
        return device_aug, probe_subject

    def _build_cache(self, training_dataset, device_aug, device, phases, mesh=None):
        """The device cache of the pretransformed training set and the
        infinite stream of full batches of subject ids for it."""
        from ..data.device_cache import DeviceDataCache, DevicePatchCache
        from ..data.loader import PatchDataLoader, RandomSampler, StandardDataLoader

        factory = self.train_dataloader_factory
        if not isinstance(factory, (StandardDataLoader, PatchDataLoader)):
            raise ValueError("device_cache supports StandardDataLoader (whole-volume) and "
                             "PatchDataLoader (device-side patch sampling) factories")
        if not training_dataset._pretransformed:
            t = time.time()
            print("Pretransforming training data for the device cache...")
            training_dataset.preload_and_transform_subjects()
            phases["pretransform_s"] = round(time.time() - t, 2)
            print(f"Done. Took {phases['pretransform_s']}s")
        t = time.time()
        x_dtype = _normalize_compute_dtype(self.compute_dtype)
        # with device augmentation one-hot labels stay uint8 ids through the
        # warp (bit-identical, fewer bytes gathered) and expand after it
        expand = device_aug is None
        batch_size = self.training_batch_size
        hybrid_spec = self._resolved_hybrid_spec
        self._hybrid_rt = None
        if isinstance(factory, StandardDataLoader):
            cache = DeviceDataCache(training_dataset.subjects, x_dtype=x_dtype, device=device,
                                    mesh=mesh, expand_onehot=expand)
            if hybrid_spec is not None:
                from .hybrid_augment import HybridHostAugment

                # holds the pretransformed subjects the per-batch stage reads
                self._hybrid_rt = HybridHostAugment(training_dataset.subjects, hybrid_spec,
                                                    x_dtype=x_dtype, device=device, mesh=mesh)
                print(f"hybrid device cache: static channels cached, {hybrid_spec.n_channels} "
                      f"channel(s) ({', '.join(hybrid_spec.image_order)}) regenerated on host "
                      f"per batch")
            sampler_cls = factory.sampler or RandomSampler

            def epoch():
                return list(iter(sampler_cls(training_dataset)))
        else:
            if hybrid_spec is not None:
                raise ValueError(
                    "hybrid device augmentation (host channel resynthesis) is not supported "
                    "with PatchDataLoader — patches are sliced on the device, so the "
                    "regenerated channel has no whole-volume slot to splice into; use "
                    "StandardDataLoader or device_cache=False")
            cache = DevicePatchCache(training_dataset.subjects, sampler=factory.sampler,
                                     x_dtype=x_dtype, device=device, mesh=mesh,
                                     expand_onehot=expand)
            spv = factory.samples_per_volume

            def epoch():  # the queue's balance: spv patches per subject per epoch
                order = [i for i in range(len(training_dataset)) for _ in range(spv)]
                random.shuffle(order)
                return order

        def infinite_indices():
            # full batches only; an epoch's tail carries into the next
            # epoch, so every subject still appears once per epoch
            carry = []
            while True:
                order = carry + epoch()
                n_full = len(order) // batch_size * batch_size
                carry = order[n_full:]
                for j in range(0, n_full, batch_size):
                    yield order[j:j + batch_size]

        phases["cache_build_s"] = round(time.time() - t, 2)
        # the dataset whose pretransformed subjects back the cache
        self._cache_dataset = training_dataset
        print(f"Device cache: {cache.n_subjects} subjects, "
              f"{cache.nbytes / 2 ** 20:.0f} MiB on {device}")
        return cache, infinite_indices()

    def _fetch_cached(self, cache, idx, training_dataset, generator):
        """A batch from the device cache and a thunk that makes its host
        subjects, only when a scheduled training evaluator needs them. With
        a hybrid split the regenerated channels are spliced into X here,
        inside the prefetch slot, so the host work and the small upload run
        under the device's step."""
        if hasattr(cache, "sample"):  # DevicePatchCache
            batch, starts = cache.sample(idx, generator)

            def subjects_thunk():
                # host patches (a recorded Crop, an invertible history) at
                # the device-drawn starts (on a mesh, every rank's)
                from ..data.loader import extract_patch

                starts_np = all_gather_rows(starts, cache.mesh).cpu().numpy()
                return [extract_patch(training_dataset.subjects[i], starts_np[k],
                                      cache.patch_size) for k, i in enumerate(idx)]
            return subjects_thunk, batch

        def subjects_thunk():
            return [copy.deepcopy(training_dataset.subjects[i]) for i in idx]
        batch = cache.gather(idx)
        if self._hybrid_rt is not None:
            batch["X"] = self._hybrid_rt.apply(batch["X"], idx)
        return subjects_thunk, batch

    def get_filter_from_scheduled_evaluations(self, dataset, scheduled_evaluations):
        filters = []
        for scheduled in scheduled_evaluations:
            if scheduled.cohorts is not None:
                filters += [dataset.cohorts[name] for name in scheduled.cohorts]
            elif scheduled.subjects is not None:
                filters.append(RequireAttributes({"name": scheduled.subjects}))
        return AnyFilter(filters)
