"""Notebook exploration widgets.

Ported from segmentation_pipeline_tpu/visualizations/notebook.py:
interactive slice browsers over subjects (through the port's
ContourImageEvaluator) and over a model's feature maps, which forward hooks
collect under the names the JAX package's ``capture_intermediates`` gives
them (``<module path>/__call__``). ipywidgets is optional; without it the
functions render once, at the midpoint of each range and the first entry of
each list. matplotlib is imported
when a figure is drawn.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.subject import Subject
from ..evaluators.contour_image_evaluator import ContourImageEvaluator
from ..training.model import to_channels_last

PLANES = ("Saggital", "Coronal", "Axial")


def _interact(fn, **sliders):
    try:
        from ipywidgets import interact

        return interact(fn, **sliders)
    except ImportError:
        # headless: render once, at the midpoint of each range and the
        # first entry of each list (where ipywidgets starts)
        mid = {k: (v[0] + v[1]) // 2 if isinstance(v, tuple) else
               v[0] if isinstance(v, list) else v for k, v in sliders.items()}
        return fn(**mid)


def vis_features(feature_map: np.ndarray, figsize=(12, 12)):
    """Browse a (C, W, H, D) feature map: channel x plane x slice."""
    import matplotlib.pyplot as plt

    feature_map = np.asarray(feature_map)
    C, W, H, D = feature_map.shape

    def show(channel=0, plane="Axial", slice_id=0):
        dim = {"Saggital": W, "Coronal": H, "Axial": D}[plane]
        slice_id = min(slice_id, dim - 1)
        sl = {
            "Saggital": feature_map[channel, slice_id, :, :],
            "Coronal": feature_map[channel, :, slice_id, :],
            "Axial": feature_map[channel, :, :, slice_id],
        }[plane]
        fig = plt.figure(figsize=figsize)
        plt.imshow(sl.T, cmap="viridis", origin="lower")
        plt.title(f"channel {channel}, {plane} slice {slice_id}")
        plt.colorbar()
        return fig

    return _interact(show, channel=(0, C - 1), plane=list(PLANES),
                     slice_id=(0, max(W, H, D) - 1))


def vis_subject(subject: Subject, image_name: str,
                prediction_label_map_name: Optional[str] = None,
                target_label_map_name: Optional[str] = None,
                scale: float = 0.25, line_width: float = 1.5, legend: bool = True):
    """Interactive contour-overlay slice browser."""
    _, W, H, D = subject[image_name].data.shape

    def show(plane="Axial", slice_id=0):
        evaluator = ContourImageEvaluator(
            plane=plane, image_name=image_name,
            prediction_label_map_name=prediction_label_map_name,
            target_label_map_name=target_label_map_name,
            slice_id=slice_id, legend=legend, ncol=1, scale=scale,
            line_width=line_width)
        return evaluator([subject])

    return _interact(show, plane=list(PLANES), slice_id=(0, max(W, H, D) - 1))


def vis_model(model, subject: Subject, image_name: str = "X",
              filter_pattern: Optional[str] = None):
    """The activations of a SegModel's modules on one subject, in eval mode:
    {"<module path>/__call__": (C, W, H, D) array} for every module whose
    output is a volume (the last call of a module called twice), to pass to
    ``vis_features``."""
    x = torch.as_tensor(np.asarray(subject[image_name].data)[None], dtype=torch.float32,
                        device=model.device)
    model.ensure_initialized()
    out = {}

    def record(path, output):
        if isinstance(output, torch.Tensor) and output.dim() == 5 and \
                (filter_pattern is None or filter_pattern in path):
            out[path] = np.moveaxis(output[0].float().cpu().numpy(), -1, 0)

    hooks = []
    for name, module in model.module.named_modules():
        path = "/".join(name.split(".") + ["__call__"]) if name else "__call__"
        hooks.append(module.register_forward_hook(
            lambda _, __, output, path=path: record(path, output)))
    try:
        model.module.eval()
        with torch.inference_mode():
            model.module(to_channels_last(x).contiguous())
    finally:
        for hook in hooks:
            hook.remove()
    return out
