"""Intensity transforms, ported from
segmentation_pipeline_tpu/transforms/intensity.py: the deterministic ones that
the dmri_hippo and msseg2 ``default`` pipelines apply (``ReplaceNan``,
``SetDataType``, ``RescaleIntensity``). Host-side numpy, as in the JAX
package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import IntensityTransform, Transform


class ReplaceNan(Transform):
    """NaN -> constant on scalar images."""

    def __init__(self, replace_val: float = 0, **kwargs):
        super().__init__(**kwargs)
        self.replace_val = replace_val

    def apply_transform(self, subject):
        for image in self.get_images(subject, intensity_only=True):
            data = np.asarray(image.data)
            if np.issubdtype(data.dtype, np.floating):
                data = np.nan_to_num(data, nan=self.replace_val, copy=False)
            image.set_data(data)
        return None


class SetDataType(Transform):
    """Cast image data. Accepts numpy dtypes or the strings
    'float'/'float32'/'int32' etc."""

    def __init__(self, data_type, intensity_only: bool = True, **kwargs):
        super().__init__(**kwargs)
        if data_type in ("float", float):
            data_type = np.float32
        if data_type in ("int", int):
            data_type = np.int32
        self.data_type = np.dtype(data_type)
        self.intensity_only = intensity_only

    def apply_transform(self, subject):
        for image in self.get_images(subject, intensity_only=self.intensity_only):
            image.set_data(np.asarray(image.data).astype(self.data_type))
        return None


class RescaleIntensity(IntensityTransform):
    """Percentile-clamped linear rescale to an output range
    (tio.RescaleIntensity semantics: cutoffs from percentiles over the whole
    image, then an affine map to out_min_max)."""

    def __init__(self, out_min_max: Tuple[float, float] = (0.0, 1.0),
                 percentiles: Tuple[float, float] = (0.0, 100.0), **kwargs):
        super().__init__(**kwargs)
        self.out_min_max = tuple(out_min_max)
        self.percentiles = tuple(percentiles)

    @staticmethod
    def _percentiles(flat: np.ndarray, p_lo: float, p_hi: float):
        """Both percentiles from one multi-kth np.partition pass in the
        array's own dtype, with np.percentile's linear interpolation."""
        n = flat.size
        vals = []
        kths, plan = [], []
        for p in (p_lo, p_hi):
            pos = (n - 1) * (p / 100.0)
            lo_k = int(np.floor(pos))
            hi_k = min(int(np.ceil(pos)), n - 1)
            plan.append((lo_k, hi_k, pos - lo_k))
            kths += [lo_k, hi_k]
        part = np.partition(flat, sorted(set(kths)))
        for lo_k, hi_k, frac in plan:
            vals.append(float(part[lo_k]) * (1 - frac) + float(part[hi_k]) * frac)
        return vals[0], vals[1]

    def apply_transform(self, subject):
        out_min, out_max = self.out_min_max
        for image in self.get_images(subject):
            raw = image.data
            data = np.asarray(raw, dtype=np.float32)
            p_lo, p_hi = self.percentiles
            if p_lo <= 0.0 and p_hi >= 100.0:
                lo, hi = float(data.min()), float(data.max())
            else:
                lo, hi = self._percentiles(data.reshape(-1), p_lo, p_hi)
            # one owned copy, then in-place arithmetic
            data = np.clip(data, lo, hi, out=data if data is not raw else None)
            if hi - lo > 1e-12:
                data -= lo
                data *= (out_max - out_min) / (hi - lo)
                data += out_min
            else:
                data.fill(out_min)
            image.set_data(data)
        return None
