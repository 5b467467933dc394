"""Sliding-window serving of whole volumes, as msseg2's competition
inference predicts (``research/msseg2/competition/ms_inference.py``'s
``competition_predictor``: ``PatchPredict`` of the mix's patch, overlap,
batch and padding, overlaps averaged) with a ``SegModel`` of the
configuration's ModularUNet at the mix's compute dtype.

Requests carry one subject each from a pool made from the seed on the
model grid; the answer is the subject's averaged probabilities, fetched to
the host. The comparison takes a sample of the window's answers and runs
the reference network at float32 (TF32 off) over the same windows: the
largest gap of any voxel's probability.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, serving
from ..reference import layers, modular_unet
from ..reference.predict import sliding_window_average, window_starts


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
        self.inputs = [data.msseg2_input(rng, mix["grid"], mix["semi_axes"])
                       for _ in range(mix["pool"])]
        self.pool = []
        for i, x in enumerate(self.inputs):
            subject = tsp.Subject(name=f"subject-{i:03d}")
            subject["X"] = tsp.ScalarImage(tensor=x.copy(), affine=np.diag([-1.0, 1.0, 1.0, 1.0]))
            self.pool.append(subject)
        dev = None if self.device.type == "cuda" else str(self.device)
        module = tsp.ModularUNet(
            cfg["input_channels"], cfg["output_channels"], filters=list(cfg["filters"]),
            depth=len(cfg["filters"]), block_params={"residual": True},
            downsample_class=tsp.BlurConv3d,
            downsample_params={"kernel_size": 3, "stride": 2, "padding": 1},
            upsample_class=tsp.BlurConvTranspose3d,
            upsample_params={"kernel_size": 3, "stride": 2, "padding": 1, "output_padding": 0},
            remat=cfg["remat"])
        self.model = tsp.SegModel(module, compute_dtype=mix["compute_dtype"], device=dev)
        self.weights = data.make_weights(module.state_dict(), self.seed, self.model.device)
        self.model.load_state_dict({n: v.clone() for n, v in self.weights.items()})
        patch = mix["patch"]
        self.predictor = tsp.PatchPredict(
            image_names=["X"], patch_batch_size=mix["patch_batch"], patch_size=patch,
            patch_overlap=mix["overlap"], padding_mode=mix["padding_mode"],
            overlap_mode="average", device=dev)
        self.requests = serving.request_order(self.seed, mix["pool"], 1, mix["request_cycle"])
        for indices in self.requests[:mix["warmup_requests"]]:
            self.send(indices)

    def send(self, indices):
        subject = self.pool[indices[0]]
        with record_function("bench.request"):
            out, _ = self.predictor.predict(self.model, [subject])
        return np.asarray(out[0]["y_pred"].data, dtype=np.float32)

    def windows(self) -> int:
        mix = self.traffic
        return len(list(itertools.product(*(window_starts(s, mix["patch"], mix["overlap"])
                                             for s in mix["grid"]))))

    def run(self, seconds: float, tracer, window_opens) -> dict:
        mix = self.traffic
        loop = serving.closed_loop(self.send, self.requests[mix["warmup_requests"]:], seconds,
                                   self.device, tracer, mix["trace_requests"], mix["kept"],
                                   self.seed, window_opens)
        self.kept = loop["kept"]
        done = loop["attempted"] - loop["failed"]
        patch = mix["patch"]
        forward = layers.conv_flops_meta(modular_unet.build(self.config),
                                         (1, self.config["input_channels"], patch, patch, patch))
        work = {"subjects": loop["traced"],
                "dtype": "torch.bfloat16" if mix["compute_dtype"] == "bfloat16" else "torch.float32",
                "flops": loop["traced"] * self.windows() * forward}
        return {"e2e": {"serve_subjects_per_s": done / loop["elapsed"],
                        "serve_p95_ms": 1e3 * float(np.percentile(loop["latencies"], 95))},
                "attempted": loop["attempted"], "failed": loop["failed"], "work": work}

    def release(self) -> None:
        del self.model, self.predictor, self.pool
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference_probabilities(self, index: int, precision: str = "f32") -> torch.Tensor:
        model = modular_unet.build(self.config).to(self.device).eval()
        model.load_state_dict(self.weights)
        x = torch.from_numpy(self.inputs[index]).to(self.device)
        with torch.no_grad(), layers.precision(precision):
            return sliding_window_average(x, model, self.traffic["patch"],
                                          self.traffic["overlap"])

    def check(self) -> Dict[str, float]:
        worst = float("nan") if not self.kept else 0.0
        for _, indices, answer in self.kept:
            ref = self.reference_probabilities(indices[0]).cpu().numpy()
            worst = max(worst, float(np.abs(ref - answer).max()))
        return {"probability_gap": worst}

    def control(self, precision: str) -> Dict[str, float]:
        """The compared number of the reference at ``precision`` in the
        program's place."""
        worst = 0.0
        for _, indices, _ in self.kept:
            low = self.reference_probabilities(indices[0], precision)
            ref = self.reference_probabilities(indices[0])
            worst = max(worst, float((low - ref).abs().max()))
        return {"probability_gap": worst}
