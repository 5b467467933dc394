"""msseg2's training loop as users run it: ``SegmentationTrainer.train`` of
the ported configuration's context (``research/msseg2/msseg2.py``,
``get_context(tpu_fast_path=True)``: the device cache with lesion-weighted
patch draws, the device augmentation derived from the declared pipeline,
SGD at 0.001 with momentum 0.95, the class-weighted hybrid loss, the
rematerialized ModularUNet), on its schedule of evaluations, from a
training set written under the run's scratch directory
(h100_bench/data_msseg2.py).

Set-up writes the subjects, builds the context with the mix's options,
loads weights made from the seed and starts ``train``: the host pipeline's
resample, brain crop and pad run there, and the first iterations, every
scheduled evaluation among them (iteration 0 runs them all), are the
warm-up. The window and the trace follow the log records as in
``drivers/trainer.py``, whose frame this driver shares.

The comparison follows the first three steps, which the set-up drives
through the trainer's own call: the batches the program sampled and
augmented, read back from the step's input, go through three steps of the
reference (``reference/modular_unet.py`` at float32 with TF32 off, the
class-weighted hybrid loss, plain ``torch.optim.SGD``) against the
program's first loss, its first gradient (SGD's momentum buffer after one
step), the change of its parameters after three steps and of its
BatchNorm statistics after one (``trainer.step_gaps``). The change is the
worst leaf's, not the median leaf's that the Adam cells compare: SGD
moves each leaf by the learning rate times its momentum-summed gradient,
with no sign rounding that makes small leaves swing. The patch draws and
the ``OneOf`` affine-or-elastic augmentation are not followed here: that
needs a second augmentation reference; the CPU tests hold them to the JAX
package.
"""
from __future__ import annotations

import contextlib
import itertools
import random
from typing import Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .. import data, data_msseg2
from ..reference import layers, modular_unet
from ..reference.loss import hybrid_logistic_dice
from ..reference.predict import window_starts
from . import trainer

FOLLOWED_STEPS = trainer.FOLLOWED_STEPS


class Driver(trainer.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 workdir: str):
        # the recipe's batch, which the frame's window arithmetic reads here
        super().__init__(dict(config, training_batch_size=traffic["batch"]), traffic, seed,
                         device, workdir)
        self.captured = {"batch": [], "loss": []}

    def setup(self) -> None:
        from segmentation_pipeline_torch import ContourImageEvaluator
        from segmentation_pipeline_torch.ops import augment as program_augment
        from segmentation_pipeline_torch.research.msseg2 import msseg2 as ms_config
        from segmentation_pipeline_torch.training import trainer as trainer_module

        cfg, mix = self.config, self.traffic
        if self.device.type == "cuda":
            from segmentation_pipeline_torch.ops import build, conv3x3

            build.build(conv3x3.SOURCES)
        root = f"{self.workdir}/dataset"
        data_msseg2.write_msseg2_dataset(root, self.seed, mix["grid"], mix["semi_axes"],
                                         mix["subjects"])
        context = ms_config.get_context(
            device=None if self.device.type == "cuda" else str(self.device),
            variables={"DATASET_PATH": root}, patch_size=mix["patch"],
            filters=tuple(cfg["filters"]), tpu_fast_path=mix["fast_path"],
            compute_dtype=mix["compute_dtype"])
        params = context.get_component_definition("trainer")["params"]

        def keep(scheduled):
            return [s for s in scheduled if not isinstance(s.evaluator, ContourImageEvaluator)]
        context.update_component("trainer",
                                 training_evaluators=keep(params["training_evaluators"]),
                                 validation_evaluators=keep(params["validation_evaluators"]))
        context.init_components()
        self.weights = data.make_weights(context.model.module.state_dict(), self.seed,
                                         self.device)
        context.model.load_state_dict({k: v.clone() for k, v in self.weights.items()})
        self.context = context
        self.trainer_module = trainer_module
        self.validation_subjects = len(context.dataset.get_cohort_dataset("validation"))

        original_augment = program_augment.augment_batch

        def augment_batch(*args, **kwargs):
            with record_function("bench.augment"):
                return original_augment(*args, **kwargs)
        program_augment.augment_batch = augment_batch
        self._restore = [(program_augment, "augment_batch", original_augment)]

        original_make = trainer_module.make_train_step

        def make_train_step(*args, **kwargs):
            inner = original_make(*args, **kwargs)

            def step(state, batch, generator):
                k = self.step_calls
                self.step_calls += 1
                if k < FOLLOWED_STEPS:
                    self.captured["batch"].append((batch["X"].detach().clone(),
                                                   batch["y"].detach().clone()))
                with record_function("bench.step"):
                    out = inner(state, batch, generator)
                if k < FOLLOWED_STEPS:
                    self.captured["loss"].append(float(out[1]["loss"]))
                if k == 0:
                    self.first_grad = momentum_norms(out[0])
                    self.after_first = self._state()
                if k == FOLLOWED_STEPS - 1:
                    self.after = self._state()
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
        random.seed(self.seed)  # the host loaders' shuffles

    def _state(self):
        return {n: t.detach().clone() for n, t in self.context.model.module.state_dict().items()}

    # ------------------------------------------------------------------
    # the yardstick's counts
    # ------------------------------------------------------------------
    def _network(self):
        return modular_unet.build(self.config)

    def step_flops(self) -> int:
        """The convs' model FLOPs of one step: forward, input gradients
        where needed and weight gradients of the batch of patches (the
        rematerialized forward is not counted again)."""
        p = self.traffic["patch"]
        return layers.conv_flops_meta(self._network(), (self.traffic["batch"],
                                                        self.config["input_channels"], p, p, p),
                                      True)

    def sweep_flops(self) -> int:
        """The forward FLOPs of one validation sweep: every patch window of
        every validation subject, whose model grid is its brain's bounding
        box (the pipeline crops to the brain mask and pads to the patch)."""
        mix = self.traffic
        p, overlap = mix["patch"], mix["patch"] // 8
        box = data_msseg2.brain_box(mix["grid"], mix["semi_axes"])
        windows = len(list(itertools.product(*(window_starts(max(s, p), p, overlap)
                                               for s in box))))
        forward = layers.conv_flops_meta(self._network(),
                                         (1, self.config["input_channels"], p, p, p))
        return self.validation_subjects * windows * forward

    # ------------------------------------------------------------------
    # the comparison
    # ------------------------------------------------------------------
    def check(self) -> Dict[str, float]:
        if len(self.captured["loss"]) < FOLLOWED_STEPS:
            return {}
        program = (self.captured["loss"], self.first_grad, self.after_first, self.after)
        numbers, self.readings = worst_change(*trainer.step_gaps(program, self.follow("f32"),
                                                                 self.weights))
        return numbers

    def control(self, precision: str) -> Dict[str, float]:
        """The step gaps of the reference at ``precision`` in the program's
        place (with the readings that are not compared)."""
        numbers, readings = worst_change(*trainer.step_gaps(self.follow(precision),
                                                            self.follow("f32"), self.weights))
        return {**numbers, **readings}

    def follow(self, precision: str):
        """The reference's followed steps on the program's batches: the
        losses, each parameter's first gradient norm, and the state after
        the first step and after them all."""
        mix = self.traffic
        model = self._network().to(self.device)
        model.load_state_dict(self.weights)
        model.train()
        params = dict(model.named_parameters())
        optimizer = torch.optim.SGD(params.values(), lr=mix["lr"], momentum=mix["momentum"],
                                    foreach=False)
        losses, first_grad, after_first = [], None, None
        with layers.precision(precision), transposed_rounding():
            for k, (x, y) in enumerate(self.captured["batch"]):
                prediction = model(x.float().permute(0, 4, 1, 2, 3))
                loss = hybrid_logistic_dice(prediction, y.float().permute(0, 4, 1, 2, 3),
                                            class_weights=mix["class_weights"])
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                losses.append(float(loss.detach()))
                if k == 0:
                    first_grad = {n: float(p.grad.norm()) for n, p in params.items()}
                    after_first = {n: t.detach().clone() for n, t in model.state_dict().items()}
        after = {n: t.detach().clone() for n, t in model.state_dict().items()}
        return losses, first_grad, after_first, after


def worst_change(numbers, readings):
    """``step_gaps``' (numbers, readings) with the worst leaf's change
    compared and the median leaf's read."""
    numbers, readings = dict(numbers), dict(readings)
    numbers["change_gap_worst"] = readings.pop("change_gap_worst")
    readings["change_gap"] = numbers.pop("change_gap")
    return numbers, readings


def _rounded(t):
    """``layers._round(t)`` with the gradient passed straight through: the
    rounding of "tf32" is a bit cast, through which no gradient flows."""
    return t + (layers._round(t) - t).detach()


def _conv_transpose3d(x, w, b=None, stride=2, padding=1, output_padding=0):
    return F.conv_transpose3d(_rounded(x), _rounded(w), b, stride=stride, padding=padding,
                              output_padding=output_padding)


@contextlib.contextmanager
def transposed_rounding():
    """The reference ModularUNet's transposed convs with their operands
    rounded as ``layers.conv_transpose3d`` rounds them and the gradient of
    their weight kept (``layers`` loses it under "tf32", where the control
    of this cell runs); in "f32" the same products."""
    saved = modular_unet.conv_transpose3d
    modular_unet.conv_transpose3d = _conv_transpose3d
    try:
        yield
    finally:
        modular_unet.conv_transpose3d = saved


def momentum_norms(state) -> Dict[str, float]:
    """Each parameter's gradient as SGD saw it on its first step: its
    momentum buffer then (torch's SGD starts the buffer at the gradient)."""
    optimizer = state.opt_state
    return {name: float(optimizer.state[p]["momentum_buffer"].norm())
            for name, p in state.params.items()}
