"""Sliding-window serving of abdominal CT with Swin UNETR, as the BTCV
recipe serves it (MONAI's ``sliding_window_inference``: 96^3 windows at
overlap 0.5, four windows a forward, the overlaps' logits averaged, under
bfloat16 autocast; the label map saved): ``PatchPredict`` of the mix's
patch, overlap and batch with ``device_argmax``, over a ``SegModel`` of the
configuration's ``SwinUNETR`` at the mix's compute dtype.

Requests carry one subject each, the pool's subjects in a fixed cycle, a
closed loop; the answer is the subject's label map, which the predictor
fetches to the host as argmax ids and attaches one-hot. The comparison
takes a sample of the window's answers and runs the reference network at
float32 (TF32 off) window by window over the same subjects, averaging its
logits over the overlaps: where the program's label differs from the
reference's, the reference's call was close, and the compared number is
the widest such margin (its best logit less its second best) among the
voxels whose label differs. Rounding overturns only close calls, a fault
overturns any.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import data_ct, serving
from ..reference import layers, swin_unetr
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
        spacing = mix["spacing"]
        self.inputs = [data_ct.ct_volume(rng, (*mix["grid"], depth), spacing)
                       for depth in mix["depths"][:mix["pool"]]]
        self.pool = []
        for i, x in enumerate(self.inputs):
            subject = tsp.Subject(name=f"ct-{i:03d}")
            subject["X"] = tsp.ScalarImage(tensor=x.copy(), affine=np.diag([*spacing, 1.0]))
            self.pool.append(subject)
        dev = None if self.device.type == "cuda" else str(self.device)
        module = tsp.SwinUNETR(
            cfg["input_channels"], cfg["output_channels"], feature_size=cfg["feature_size"],
            depths=tuple(cfg["depths"]), num_heads=tuple(cfg["num_heads"]),
            window_size=cfg["window_size"], patch_size=cfg["patch_size"],
            mlp_ratio=cfg["mlp_ratio"], qkv_bias=cfg["qkv_bias"], normalize=cfg["normalize"])
        self.model = tsp.SegModel(module, compute_dtype=mix["compute_dtype"], device=dev)
        self.weights = data_ct.swin_weights(module.state_dict(), self.seed, self.model.device)
        self.model.load_state_dict({n: v.clone() for n, v in self.weights.items()})
        self.predictor = tsp.PatchPredict(
            image_names=["X"], patch_batch_size=mix["patch_batch"], patch_size=mix["patch"],
            patch_overlap=mix["overlap"], overlap_mode="average", device_argmax=True,
            device=dev)
        self.requests = [[k % len(self.pool)] for k in range(mix["request_cycle"])]
        for indices in self.requests[:mix["warmup_requests"]]:
            self.send(indices)

    def send(self, indices):
        subject = self.pool[indices[0]]
        with record_function("bench.request"):
            out, _ = self.predictor.predict(self.model, [subject])
        return out[0]["y_pred"].data  # one-hot on the host

    def windows(self, index: int) -> int:
        mix = self.traffic
        shape = self.inputs[index].shape[1:]
        return len(list(itertools.product(*(window_starts(s, mix["patch"], mix["overlap"])
                                             for s in shape))))

    def window_flops(self) -> int:
        patch = self.traffic["patch"]
        return swin_unetr.flops(self.config, (1, self.config["input_channels"],
                                              patch, patch, patch))

    def run(self, seconds: float, tracer, window_opens) -> dict:
        mix = self.traffic
        requests = self.requests[mix["warmup_requests"]:]
        loop = serving.closed_loop(self.send, requests, seconds, self.device, tracer,
                                   mix["trace_requests"], mix["kept"], self.seed, window_opens)
        self.kept = loop["kept"]
        done = loop["attempted"] - loop["failed"]
        work = {}
        if tracer is not None:
            windows = sum(self.windows(requests[k][0]) for k in range(loop["traced"]))
            work = {"subjects": loop["traced"], "windows": windows,
                    "dtype": "torch.bfloat16" if mix["compute_dtype"] == "bfloat16"
                    else "torch.float32",
                    "flops": windows * self.window_flops()}
        return {"e2e": {"serve_subjects_per_s": done / loop["elapsed"],
                        "serve_p95_ms": 1e3 * float(np.percentile(loop["latencies"], 95))},
                "attempted": loop["attempted"], "failed": loop["failed"], "work": work}

    def release(self) -> None:
        del self.model, self.predictor, self.pool
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference_logits(self, index: int, precision: str = "f32") -> torch.Tensor:
        """The reference's overlap-averaged logits (C, W, H, D) of a subject."""
        model = swin_unetr.build(self.config).to(self.device).eval()
        model.load_state_dict(self.weights)
        x = torch.from_numpy(self.inputs[index]).to(self.device)
        with torch.no_grad(), layers.precision(precision):
            return sliding_window_average(x, model, self.traffic["patch"],
                                          self.traffic["overlap"])

    @staticmethod
    def _numbers(pairs):
        """The compared number over (labels, reference logits) pairs, and the
        share of voxels whose label differs."""
        widest, differs_n, voxels = 0.0, 0, 0
        for labels, logits in pairs:
            top = logits.topk(2, dim=0).values
            differs = labels != logits.argmax(0)
            if differs.any():
                widest = max(widest, float((top[0] - top[1])[differs].max()))
            differs_n += int(differs.sum())
            voxels += differs.numel()
        return {"overturned_margin": widest}, {"label_mismatch_share": differs_n / max(voxels, 1)}

    def check(self) -> Dict[str, float]:
        if not self.kept:
            return {"overturned_margin": float("nan")}
        pairs = []
        for _, indices, answer in self.kept:
            labels = torch.from_numpy(np.asarray(answer).argmax(0)).to(self.device)
            pairs.append((labels, self.reference_logits(indices[0])))
        numbers, self.readings = self._numbers(pairs)
        return numbers

    def control(self, precision: str) -> Dict[str, float]:
        """The compared number of the reference at ``precision`` in the
        program's place, with the readings beside it."""
        pairs = []
        for _, indices, _ in self.kept:
            low = self.reference_logits(indices[0], precision).argmax(0)
            pairs.append((low, self.reference_logits(indices[0])))
        numbers, readings = self._numbers(pairs)
        return {**numbers, **readings}
