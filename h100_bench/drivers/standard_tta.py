"""Test-time-augmented serving of whole volumes, as
``research/dmri_hippo/hippo_inference.py --ensemble-flips --ensemble-folds
--batched-tta`` predicts: ``StandardPredict(sagittal_split=True)`` over an
``EnsembleModels`` majority of folds, each an ``EnsembleFlips`` majority
over the flips of the mix's axes folded into one batch, each fold a
``SegModel`` of the configuration's network at the mix's compute dtype.

Requests carry ``subjects_per_request`` subjects from a pool made from the
seed at the crop; the answer is each subject's voted one-hot label map,
fetched to the host. The comparison takes a sample of the window's answers and
votes again with the reference network at float32 (TF32 off), each fold's
weights made from the seed as the program's were (the benchmark sets their
BatchNorm statistics to those of one request's batch, as a trained
network's are; with the drawn statistics the random networks' calls were
so one-sided that on some seeds no rounding, not even fp8's, moved a
voxel's vote). Where the program's
label differs from the reference's, the reference's vote hung on a member
whose call was close; the compared number is the widest such closest
margin (a member's best class's logit less its second best's, the
smallest over the members at that voxel) among the voxels whose label
differs: rounding overturns only close calls, a fault overturns any.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, serving
from ..reference import layers, nested_res_unet
from ..reference.predict import flip_tta, majority, merge_halves, split_and_flip


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device

    def setup(self) -> None:
        import segmentation_pipeline_torch as tsp

        cfg, mix = self.config, self.traffic
        if self.device.type == "cuda":
            from segmentation_pipeline_torch.ops import build, conv3x3

            build.build(conv3x3.SOURCES)
        rng = np.random.default_rng(self.seed)
        self.inputs = [data.hippo_input(rng, cfg["crop_shape"]) for _ in range(mix["pool"])]
        self.pool = []
        for i, x in enumerate(self.inputs):
            subject = tsp.Subject(name=f"subject-{i:03d}")
            subject["X"] = tsp.ScalarImage(tensor=x.copy(), affine=np.diag(
                [-data.HIPPO_SPACING[0], *data.HIPPO_SPACING[1:], 1.0]))
            self.pool.append(subject)
        dev = None if self.device.type == "cuda" else str(self.device)
        folds, self.weights = [], []
        # each fold's BatchNorm statistics are those of the pool's first
        # request's split batch, as if trained on such subjects
        first = torch.from_numpy(np.stack(self.inputs[:mix["subjects_per_request"]]))
        for k in range(mix["folds"]):
            module = tsp.NestedResUNet(cfg["input_channels"], cfg["output_channels"],
                                       filters=cfg["filters"], dropout_p=cfg["dropout_p"])
            model = tsp.SegModel(module, compute_dtype=mix["compute_dtype"], device=dev)
            weights = data.make_weights(module.state_dict(), self.seed + k, model.device)
            reference = nested_res_unet.build(cfg).to(model.device).eval()
            reference.load_state_dict(weights)
            with torch.no_grad(), layers.statistics_adopted(reference):
                reference(split_and_flip(first.to(model.device)))
            weights = {n: v.detach().clone() for n, v in reference.state_dict().items()}
            model.load_state_dict({n: v.clone() for n, v in weights.items()})
            self.weights.append(weights)
            folds.append(tsp.EnsembleFlips(model, strategy="majority",
                                           spatial_dims=tuple(mix["flip_dims"]), batched=True))
        self.model = tsp.EnsembleModels(folds, "majority")
        self.predictor = tsp.StandardPredict(image_names=["X"], sagittal_split=True, device=dev)
        self.requests = serving.request_order(self.seed, mix["pool"],
                                              mix["subjects_per_request"], mix["request_cycle"])
        for indices in self.requests[:mix["warmup_requests"]]:
            self.send(indices)

    def send(self, indices):
        subjects = [self.pool[i] for i in indices]
        with record_function("bench.request"):
            out, _ = self.predictor.predict(self.model, subjects)
        return [s["y_pred"].data for s in out]

    def run(self, seconds: float, tracer, window_opens) -> dict:
        mix = self.traffic
        loop = serving.closed_loop(self.send, self.requests[mix["warmup_requests"]:], seconds,
                                   self.device, tracer, mix["trace_requests"], mix["kept"],
                                   self.seed, window_opens)
        self.kept = loop["kept"]
        done = loop["attempted"] - loop["failed"]
        per = mix["subjects_per_request"]
        work = {"subjects": loop["traced"] * per,
                "dtype": "torch.bfloat16" if mix["compute_dtype"] == "bfloat16" else "torch.float32",
                "flops": loop["traced"] * self.request_flops()}
        return {"e2e": {"serve_subjects_per_s": done * per / loop["elapsed"],
                        "serve_p95_ms": 1e3 * float(np.percentile(loop["latencies"], 95))},
                "attempted": loop["attempted"], "failed": loop["failed"], "work": work}

    def request_flops(self) -> int:
        """The convs' FLOPs of every forward a request needs: each fold on
        every flip of the split batch."""
        W, H, D = self.config["crop_shape"]
        mix = self.traffic
        n = 2 * mix["subjects_per_request"] * 2 ** len(mix["flip_dims"])
        return mix["folds"] * layers.conv_flops_meta(
            nested_res_unet.build(self.config), (n, self.config["input_channels"], W // 2, H, D))

    def release(self) -> None:
        del self.model, self.predictor, self.pool
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference_labels(self, indices, precision: str = "f32"):
        """The reference's voted labels (N, W, H, D) of a request and the
        closest member call at each voxel."""
        cfg, mix = self.config, self.traffic
        x = torch.from_numpy(np.stack([self.inputs[i] for i in indices])).to(self.device)
        folds, margin = [], None
        with torch.no_grad(), layers.precision(precision):
            for weights in self.weights:
                model = nested_res_unet.build(cfg).to(self.device).eval()
                model.load_state_dict(weights)
                labels, m = flip_tta(model, split_and_flip(x), mix["flip_dims"],
                                     cfg["output_channels"])
                folds.append(labels)
                margin = m if margin is None else torch.minimum(margin, m)
        voted = majority(folds, cfg["output_channels"])
        return merge_halves(voted[:, None])[:, 0], merge_halves(margin[:, None])[:, 0]

    @staticmethod
    def _numbers(pairs):
        """The compared number over (labels, reference labels, margins) of
        the kept requests, and the share of voxels whose label differs."""
        widest, differs_n, voxels = 0.0, 0, 0
        for labels, reference, margin in pairs:
            differs = labels != reference
            if differs.any():
                widest = max(widest, float(margin[differs].max()))
            differs_n += int(differs.sum())
            voxels += differs.numel()
        return {"overturned_margin": widest}, {"label_mismatch_share": differs_n / max(voxels, 1)}

    def check(self) -> Dict[str, float]:
        if not self.kept:
            return {"overturned_margin": float("nan")}
        pairs = []
        for _, indices, answer in self.kept:
            ref, margin = self.reference_labels(indices)
            labels = np.stack([np.asarray(a).argmax(0) for a in answer])
            pairs.append((torch.from_numpy(labels).to(ref.device), ref, margin))
        numbers, self.readings = self._numbers(pairs)
        return numbers

    def control(self, precision: str) -> Dict[str, float]:
        """The compared number of the reference at ``precision`` in the
        program's place, with the readings beside it."""
        pairs = []
        for _, indices, _ in self.kept:
            low, _ = self.reference_labels(indices, precision)
            pairs.append((low, *self.reference_labels(indices)))
        numbers, readings = self._numbers(pairs)
        return {**numbers, **readings}
