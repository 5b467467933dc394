"""The training loop as users run it: ``SegmentationTrainer.train`` of a
ported configuration's context, on its schedule of evaluations, from a
training set written under the run's scratch directory.

Set-up writes the subjects, builds the context with the mix's options
(the fast path: device cache and device augmentation), loads weights made
from the seed and starts ``train``; the first iterations, every scheduled
evaluation among them (iteration 0 runs them all), are the warm-up. The
window opens when the log record of iteration ``warmup_iterations - 1``
arrives and closes at the first record ``--seconds`` later; a record
arrives once the host has read that iteration's loss. Training samples
per second are the iterations between the two records, times the batch,
over the time between them, evaluations and sweeps included.

The comparison follows the first three steps, which the set-up drives
through the trainer's own call and feed: the rows the cache gathered
(matched against the reference's preprocessing of the raw volumes), the
augmentation of those rows (the reference's, at the generator state the
program drew from), and three steps of the reference (dropout masks from
the generator state each step drew from, Adam at the configuration's rate,
TF32 off) against the program's first loss, its first gradient (read from
Adam's first moment after one step), the change of its parameters after
three steps and of its BatchNorm statistics after one (``step_gaps``).
"""
from __future__ import annotations

import random
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import data
from ..reference import augment as ref_augment
from ..reference import layers, nested_res_unet, pretransform
from ..reference.loss import hybrid_logistic_dice
from ..reference.predict import merge_halves, split_and_flip

FOLLOWED_STEPS = 3


def gap(program: float, reference: float, scale: float) -> float:
    return abs(program - reference) / scale


class _Logger:
    """The trainer's logger: keeps no files, stamps each record's arrival
    and moves the window and the trace at the iterations the driver set."""

    def __init__(self, driver):
        self.driver = driver

    def setup(self, context):
        pass

    def save_context(self, context, folder, iteration):
        pass

    def close(self):
        pass

    def log(self, record):
        self.driver.on_record(record["iteration"], time.perf_counter())


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        self.aug_calls = self.step_calls = 0
        self.captured = {"gather": [], "aug_state": [], "augmented": [], "step_state": [],
                         "loss": []}

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------
    def setup(self) -> None:
        from segmentation_pipeline_torch import ContourImageEvaluator
        from segmentation_pipeline_torch.ops import augment as program_augment
        from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config
        from segmentation_pipeline_torch.training import trainer as trainer_module

        cfg, mix = self.config, self.traffic
        if self.device.type == "cuda":
            from segmentation_pipeline_torch.ops import build, conv3x3

            build.build(conv3x3.SOURCES)
        root = f"{self.workdir}/dataset"
        data.write_hippo_dataset(root, self.seed, mix["raw_grid"], mix["subjects"])
        context = main_config.get_context(
            device=None if self.device.type == "cuda" else str(self.device),
            variables={"DATASET_PATH": root}, training_batch_size=cfg["training_batch_size"],
            crop_shape=tuple(cfg["crop_shape"]), filters=cfg["filters"],
            tpu_fast_path=mix["fast_path"], compute_dtype=mix["compute_dtype"])
        params = context.get_component_definition("trainer")["params"]

        def keep(scheduled):
            return [s for s in scheduled if not isinstance(s.evaluator, ContourImageEvaluator)]
        context.update_component("trainer",
                                 training_evaluators=keep(params["training_evaluators"]),
                                 validation_evaluators=keep(params["validation_evaluators"]))
        context.init_components()
        template = context.model.module.state_dict()
        self.weights = data.make_weights(template, self.seed, self.device)
        context.model.load_state_dict({k: v.clone() for k, v in self.weights.items()})
        self.context = context
        self.trainer_module = trainer_module

        # the benchmark's spans and the capture of the followed steps
        original_augment = program_augment.augment_batch

        def augment_batch(generator, X, y=None, config=None, shard=None):
            k = self.aug_calls
            self.aug_calls += 1
            if k < FOLLOWED_STEPS:
                self.captured["gather"].append((X.detach().clone(), y.detach().clone()))
                self.captured["aug_state"].append(generator.get_state())
            with record_function("bench.augment"):
                out = original_augment(generator, X, y, config=config, shard=shard)
            if k < FOLLOWED_STEPS:
                self.captured["augmented"].append((out[0].detach().clone(),
                                                   out[1].detach().clone()))
            return out
        program_augment.augment_batch = augment_batch
        self._restore = [(program_augment, "augment_batch", original_augment)]

        original_make = trainer_module.make_train_step

        def make_train_step(*args, **kwargs):
            inner = original_make(*args, **kwargs)

            def step(state, batch, generator):
                k = self.step_calls
                self.step_calls += 1
                if k < FOLLOWED_STEPS:
                    self.captured["step_state"].append(generator.get_state())
                with record_function("bench.step"):
                    out = inner(state, batch, generator)
                if k < FOLLOWED_STEPS:
                    self.captured["loss"].append(float(out[1]["loss"]))
                if k == 0:
                    self.first_moment = first_moments(out[0])
                    self.after_first = {n: t.detach().clone() for n, t in
                                        self.context.model.module.state_dict().items()}
                if k == FOLLOWED_STEPS - 1:
                    self.after = {n: t.detach().clone()
                                  for n, t in self.context.model.module.state_dict().items()}
                return out
            return step
        trainer_module.make_train_step = make_train_step
        self._restore.append((trainer_module, "make_train_step", original_make))

        predictor = context.trainer.validation_predictor
        original_predict = predictor.predict

        def predict(*args, **kwargs):
            with record_function("bench.sweep"):
                return original_predict(*args, **kwargs)
        predictor.predict = predict
        random.seed(self.seed)  # the training sampler's shuffles

    # ------------------------------------------------------------------
    # the window
    # ------------------------------------------------------------------
    def on_record(self, iteration: int, now: float) -> None:
        mix = self.traffic
        start = mix["warmup_iterations"] - 1
        if iteration == start:
            self.window = {"i0": iteration, "t0": now}
            self.window_opens()
        if self.tracer is not None:
            period = mix["trace_iterations"]
            if iteration == mix["trace_from"] - 1:
                self.tracer.start()
                self.traced_from = iteration
            elif iteration == mix["trace_from"] - 1 + period and self.tracer.active:
                self.tracer.stop()
                self.traced = (self.traced_from, iteration)
        if iteration > start and now - self.window["t0"] >= self.seconds \
                and (self.tracer is None or self.tracer.summary is not None):
            self.window.update(i1=iteration, t1=now)
            self.trainer_module.EXIT.set()

    def run(self, seconds: float, tracer, window_opens) -> dict:
        self.seconds, self.tracer, self.window_opens = seconds, tracer, window_opens
        context = self.context
        try:
            context.trainer.train(context, max_iterations=10 ** 9,
                                  num_workers=self.traffic["num_workers"],
                                  validation_batch_size=self.traffic["validation_batch_size"],
                                  logger=_Logger(self))
        finally:
            for owner, name, value in self._restore:
                setattr(owner, name, value)
        w = self.window
        iterations = w["i1"] - w["i0"]
        batch = self.config["training_batch_size"]
        work = {}
        if tracer is not None:
            a, b = self.traced
            work = {"steps": b - a, "step_flops": self.step_flops(),
                    "sweeps": sum(1 for i in range(a + 1, b + 1)
                                  if i % self.traffic["sweep_interval"] == 0),
                    "sweep_flops": self.sweep_flops(), "dtype": self.dtype_name()}
        return {"e2e": {"train_samples_per_s": iterations * batch / (w["t1"] - w["t0"])},
                "attempted": iterations, "failed": 0, "work": work}

    def dtype_name(self) -> str:
        return "torch.bfloat16" if self.traffic["compute_dtype"] == "bfloat16" \
            else "torch.float32"

    def _crop(self):
        return tuple(self.config["crop_shape"])

    def step_flops(self) -> int:
        """The convs' model FLOPs of one step: forward, input gradients
        where needed and weight gradients, at the split batch."""
        W, H, D = self._crop()
        n = 2 * self.config["training_batch_size"]
        return layers.conv_flops_meta(nested_res_unet.build(self.config),
                                      (n, self.config["input_channels"], W // 2, H, D), True)

    def sweep_flops(self) -> int:
        W, H, D = self._crop()
        n = 2 * self.traffic["subjects"]["validation"] + 2 * self.traffic["subjects"]["ab300"]
        return layers.conv_flops_meta(nested_res_unet.build(self.config),
                                      (n, self.config["input_channels"], W // 2, H, D))

    def release(self) -> None:
        del self.context
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the comparison
    # ------------------------------------------------------------------
    def reference_subjects(self):
        """The reference's preprocessing of the training cohort's raw
        volumes: X (S, W, H, D, 3) and y (S, W, H, D) on the device."""
        raw, union = data.hippo_training_volumes(self.seed, self.traffic["raw_grid"],
                                                 self.traffic["subjects"])
        pairs = [pretransform.hippo_training_subject(v, union, self._crop()) for v in raw]
        X = torch.from_numpy(np.stack([p[0] for p in pairs])).permute(0, 2, 3, 4, 1)
        y = torch.from_numpy(np.stack([p[1] for p in pairs]))
        return X.contiguous().to(self.device), y.to(self.device)

    def batches(self):
        """The stage checks (the gathered rows, their augmentation) and the
        reference's batches of the followed steps."""
        cap = self.captured
        X_ref, y_ref = self.reference_subjects()
        # the spacing the subjects carry: their NIfTI headers hold float32
        aug_cfg = ref_augment.config(tuple(float(np.float32(v)) for v in data.HIPPO_SPACING))
        out = {"gather_gap": 0.0, "augment_x_gap": 0.0, "augment_y_mismatch": 0.0}
        batches = []
        for k in range(FOLLOWED_STEPS):
            gx, gy = cap["gather"][k]
            rows = []
            for r in range(gx.shape[0]):
                d = (X_ref - gx[r].float()).abs().flatten(1).amax(1) \
                    + (y_ref != gy[r]).flatten(1).float().amax(1)
                j = int(d.argmin())
                rows.append(j)
                out["gather_gap"] = max(out["gather_gap"], float(d[j]))
            if len(set(rows)) != len(rows):
                out["gather_gap"] = float("inf")  # the rows of a batch must differ
            g = torch.Generator(device=self.device)
            g.set_state(cap["aug_state"][k])
            xa, ya = ref_augment.augment(g, X_ref[rows], y_ref[rows], aug_cfg)
            px, py = cap["augmented"][k]
            out["augment_x_gap"] = max(out["augment_x_gap"], float((xa - px.float()).abs().max()))
            out["augment_y_mismatch"] = max(out["augment_y_mismatch"],
                                            float((ya != py).float().mean()))
            batches.append((xa, ya))
        return out, batches

    def check(self) -> Dict[str, float]:
        if len(self.captured["loss"]) < FOLLOWED_STEPS:
            return {}
        out, batches = self.batches()
        program = (self.captured["loss"], self.first_moment, self.after_first, self.after)
        numbers, self.readings = step_gaps(program, self.follow(batches, "f32"), self.weights)
        out.update(numbers)
        return out

    def control(self, precision: str) -> Dict[str, float]:
        """The step gaps of the reference at ``precision`` in the program's
        place (with the readings that are not compared)."""
        _, batches = self.batches()
        numbers, readings = step_gaps(self.follow(batches, precision),
                                      self.follow(batches, "f32"), self.weights)
        return {**numbers, **readings}

    def follow(self, batches, precision: str):
        """The reference's followed steps on its own batches: the losses,
        each parameter's first gradient norm, and the state after the first
        step and after them all."""
        cfg = self.config
        model = nested_res_unet.build(cfg).to(self.device)
        model.load_state_dict(self.weights)
        model.train()
        params = dict(model.named_parameters())
        optimizer = torch.optim.Adam(params.values(), lr=cfg["lr"], foreach=False)
        losses, first_grad, after_first = [], None, None
        with layers.precision(precision):
            for k, (xa, ya) in enumerate(batches):
                g = torch.Generator(device=self.device)
                g.set_state(self.captured["step_state"][k])
                x = split_and_flip(xa.permute(0, 4, 1, 2, 3))
                y_pred = merge_halves(model(x, g))
                target = torch.nn.functional.one_hot(ya.long(), cfg["output_channels"])
                loss = hybrid_logistic_dice(y_pred, target.permute(0, 4, 1, 2, 3).float())
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                losses.append(float(loss.detach()))
                if k == 0:
                    first_grad = {n: float(p.grad.norm()) for n, p in params.items()}
                    after_first = {n: t.detach().clone() for n, t in model.state_dict().items()}
        after = {n: t.detach().clone() for n, t in model.state_dict().items()}
        return losses, first_grad, after_first, after


def step_gaps(side, reference, before):
    """The relative gaps of one side's followed steps to the reference's,
    each against the reference's norm of that leaf or of the median leaf,
    whichever is larger, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's. Compared: the first step's
    loss; the worst leaf's first gradient; the median leaf's change after
    the steps; the worst BatchNorm statistic after the first step. Returned
    beside them, not compared (Adam's first steps move a leaf's elements of
    near-zero gradient by the learning rate whichever sign rounding gives
    them, so these swing from seed to seed): every step's loss, the worst
    leaf's change and the worst statistic after the steps."""
    losses, grads, first, after = side
    ref_losses, ref_grads, ref_first, ref_after = reference
    median_grad = float(np.median(list(ref_grads.values())))
    moved = [n for n, v in ref_grads.items() if v >= 1e-3 * median_grad]
    stats = [n for n in ref_after if n.endswith(("running_mean", "running_var"))]

    def change_gaps(names, mine, ref):
        norms = {n: float((ref[n] - before[n]).norm()) for n in names}
        median = float(np.median(list(norms.values())))
        return [gap(float((mine[n] - before[n]).norm()), norms[n], max(norms[n], median))
                for n in names]
    numbers = {"loss_gap": gap(losses[0], ref_losses[0], abs(ref_losses[0])),
               "grad_gap": max(gap(grads[n], ref_grads[n], max(ref_grads[n], median_grad))
                               for n in moved),
               "change_gap": float(np.median(change_gaps(moved, after, ref_after))),
               "stats_gap": max(change_gaps(stats, first, ref_first))}
    readings = {"loss_gap_steps": max(gap(p, r, abs(r)) for p, r in zip(losses, ref_losses)),
                "change_gap_worst": max(change_gaps(moved, after, ref_after)),
                "stats_gap_steps": max(change_gaps(stats, after, ref_after))}
    return numbers, readings


def first_moments(state) -> Dict[str, float]:
    """Each parameter's gradient as Adam saw it on its first step: its first
    moment over (1 - beta1)."""
    optimizer = state.opt_state
    beta1 = optimizer.param_groups[0]["betas"][0]
    return {name: float(optimizer.state[p]["exp_avg"].norm()) / (1 - beta1)
            for name, p in state.params.items()}

