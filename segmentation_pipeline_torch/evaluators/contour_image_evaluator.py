"""Qualitative contour-overlay montage images, copied from
segmentation_pipeline_tpu/evaluators/contour_image_evaluator.py: slices
volumes per subject (fixed, random-plane, or label-mass 'interesting' slice
selection), tiles a grid, overlays target (solid) vs prediction (dashed)
contours with per-label colors, returns a PIL image. The slicing and the
grid are numpy; the rendering imports matplotlib and PIL when it runs and
raises ImportError where they are not installed.
"""
from __future__ import annotations

import io
import random
import warnings
from typing import Optional

import numpy as np

from ..core.subject import slice_volume
from ..transforms.misc import FindInterestingSlice
from .evaluator import Evaluator

PLANES = ("Axial", "Coronal", "Saggital")


def make_grid(slices, ncol: int, pad_value: float = 0.0, padding: int = 1) -> np.ndarray:
    """Tile 2-D arrays into a grid (torchvision make_grid analog)."""
    n = len(slices)
    ncol = max(1, min(ncol, n))
    nrow = (n + ncol - 1) // ncol
    h = max(s.shape[0] for s in slices)
    w = max(s.shape[1] for s in slices)
    grid = np.full((nrow * (h + padding) + padding, ncol * (w + padding) + padding),
                   pad_value, dtype=np.float32)
    for idx, s in enumerate(slices):
        r, c = divmod(idx, ncol)
        y0 = padding + r * (h + padding)
        x0 = padding + c * (w + padding)
        grid[y0:y0 + s.shape[0], x0:x0 + s.shape[1]] = s
    return grid


class ContourImageEvaluator(Evaluator):
    def __init__(self, plane: str, image_name: str,
                 prediction_label_map_name: Optional[str],
                 target_label_map_name: Optional[str],
                 slice_id: int, legend: bool, ncol: int, scale: float = 0.1,
                 line_width: float = 1.5, interesting_slice: bool = False,
                 split_subjects: bool = False):
        self.plane = plane
        self.image_name = image_name
        self.prediction_label_map_name = prediction_label_map_name
        self.target_label_map_name = target_label_map_name
        self.slice_id = slice_id
        self.legend = legend
        self.ncol = ncol
        self.scale = scale
        self.line_width = line_width
        self.interesting_slice = interesting_slice
        self.split_subjects = split_subjects

    # ---- slice selection ----------------------------------------------
    def _get_slice_id(self, subject, plane):
        if not self.interesting_slice:
            return self.slice_id, plane

        name = (self.target_label_map_name
                if self.target_label_map_name in subject
                else self.prediction_label_map_name)
        image = subject[name]
        if "interesting_slice_ids" not in image:
            from ..core.subject import Subject

            tmp = Subject({"__label__": image})
            FindInterestingSlice()(tmp, record=False)

        ids = image["interesting_slice_ids"]
        counts = image["interesting_slice_counts"]
        if plane.lower() == "interesting":
            best_count = -1
            for check_plane in PLANES:
                c = self._slice_property(image, counts, self.slice_id, check_plane)
                if c > best_count:
                    plane, best_count = check_plane, c
        return self._slice_property(image, ids, self.slice_id, plane), plane

    @staticmethod
    def _slice_property(image, prop, slice_id, plane):
        _, W, H, D = image.data.shape
        dim = {"Axial": D, "Coronal": H, "Saggital": W}[plane]
        arr = prop[plane]
        if len(arr) == 0:
            return dim // 2
        if slice_id >= len(arr):
            return int(arr[-1])
        return int(arr[slice_id])

    def _plane_to_arg(self, plane):
        return {"Axial": "axial", "Coronal": "coronal", "Saggital": "sagittal"}[plane]

    def _slice_and_make_grid(self, subjects, plane, image_name, impute_shape, pad_value=0.0):
        slices = []
        for subject in subjects:
            slice_id, plane_i = self._get_slice_id(subject, plane)
            if image_name in subject:
                _, W, H, D = subject[image_name].data.shape
                dim = {"Axial": D, "Coronal": H, "Saggital": W}[plane_i]
                slice_id = min(int(slice_id), dim - 1)  # clamp for small volumes
                slices.append(np.asarray(slice_volume(
                    subject[image_name].data, 0, self._plane_to_arg(plane_i), slice_id),
                    dtype=np.float32).T)
            else:
                slices.append(np.zeros(impute_shape, dtype=np.float32))
        return make_grid(slices, ncol=self.ncol, pad_value=pad_value)

    # ---- main ----------------------------------------------------------
    def __call__(self, subjects):
        if not self.split_subjects:
            return self.get_image(subjects)
        return {s["name"]: self.get_image([s]) for s in subjects}

    def get_image(self, subjects):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import colormaps
        from PIL import Image as PILImage

        first = subjects[0]
        out_pred = (self.prediction_label_map_name is not None
                    and self.prediction_label_map_name in first)
        out_target = (self.target_label_map_name is not None
                      and self.target_label_map_name in first)

        label_values = {}
        if out_pred:
            label_values = first[self.prediction_label_map_name].get("label_values", {"label": 1})
        if out_target:
            label_values = first[self.target_label_map_name].get("label_values", label_values)

        plane = self.plane
        if plane.lower() == "random":
            plane = PLANES[random.randint(0, 2)]

        slice_id, plane_resolved = self._get_slice_id(first, plane)
        sample = slice_volume(first[self.image_name].data, 0,
                              self._plane_to_arg(plane_resolved), 0)
        impute_shape = np.asarray(sample).T.shape

        img = self._slice_and_make_grid(subjects, plane, self.image_name,
                                        impute_shape, pad_value=-1)
        # slice each label map ONCE and compare per label (slicing per label
        # per map would redo the grid 2L times)
        masks_target = {}
        masks_pred = {}
        if out_target:
            target_grid = self._slice_and_make_grid(
                subjects, plane, self.target_label_map_name, impute_shape)
            masks_target = {name: target_grid == value
                            for name, value in label_values.items()}
        if out_pred:
            pred_grid = self._slice_and_make_grid(
                subjects, plane, self.prediction_label_map_name, impute_shape)
            masks_pred = {name: pred_grid == value
                          for name, value in label_values.items()}

        H, W = img.shape
        fig = plt.figure(figsize=(W * self.scale, H * self.scale))
        plt.imshow(img, cmap="gray")
        Xg, Yg = np.meshgrid(np.arange(W), np.arange(H))
        options = dict(linewidths=self.line_width, alpha=1.0)
        cmap = ([None, "r", "g", "b", "y", "c", "m"]
                + list(colormaps["Accent"].colors) + list(colormaps["Dark2"].colors)
                + list(colormaps["Set1"].colors) + list(colormaps["Set2"].colors)
                + list(colormaps["tab20"].colors))

        with warnings.catch_warnings():
            # scoped: resetwarnings() here would clobber the process-global
            # warning filters installed by the application or pytest
            warnings.simplefilter("ignore")
            if out_target:
                handles, handle_labels = [], []
                for name, value in label_values.items():
                    contour = plt.contour(Xg, Yg, masks_target[name], levels=[0.5],
                                          colors=cmap[value:value + 1], **options)
                    elements = contour.legend_elements()[0]
                    if elements:  # empty contour -> no legend entry
                        handles.append(elements[0])
                        handle_labels.append(name)
                if self.legend and handles:
                    plt.legend(handles, handle_labels, ncol=3,
                               bbox_to_anchor=(0.5, 0), loc="upper center",
                               fancybox=True)
            if out_pred:
                for name, value in label_values.items():
                    plt.contour(Xg, Yg, masks_pred[name], levels=[0.95],
                                linestyles="dashed",
                                colors=cmap[value:value + 1], **options)

        plt.tick_params(which="both", bottom=False, top=False, left=False,
                        labelbottom=False, labelleft=False)
        buf = io.BytesIO()
        fig.savefig(buf, bbox_inches="tight", pad_inches=0.0, facecolor="black")
        buf.seek(0)
        pil_image = PILImage.open(buf)
        pil_image.load()
        plt.close(fig)
        return pil_image
